#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tmv_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two main paths through their entry points, through the two
hand-written CUDA kernels: YOLOv4 @640 (80 classes, full width) and
EfficientDet-D0 @512 (81 classes, full width and depth), each predicting and
served at ``POST /ai_api/object_detection/predict``, on seeded random weights;
then each model's trainer and eval CLI; then YOLOv3 @416 and the ResNet50V2
YOLO tower (phases 15-17), whose IoU NMS goes through the same sweep kernel;
then YOLOv4 @608 mosaic training with the staging cache and ``--remat``, UNet
@128 training, and the WSGI entry and detect CLI (phases 18-20); then the FaceNet
family (phase 21), which launches neither kernel; then MoCo pretraining, export
and fine-tune, and teacher→student distillation, whose pseudo-labeler sweeps
through the NMS kernel (phase 22); then int8 serving and eval through the two int8
conv kernels (phase 23); then the serving artifacts of ``cli/export_model.py``
served by ``serve --artifact``, every kernel in them as a ``tmv::`` op (phase 24);
then data-parallel training through the trainers' ``--dp``/``--fsdp`` and sharded
serving through ``serve --dp`` (phase 25); then the image height split over two
shards with hand-written halo exchanges: ``serve --spatial 2`` and ``train_yolo --sp
2`` (phase 26).
Phases, each printing its own lines:

1. environment: torch/CUDA/nvcc versions and the card (nvidia-smi);
2. build: the three kernel sources at once (one nvcc each, started together),
   with each build's time, registers per thread and shared memory per block of
   every instantiation (ptxas for the NMS stages, the CUDA runtime for the float
   depthwise kernel and for the int8 kernels, the quantize pass, the GEMM at each
   tile width and the depthwise kernel at each k and stride, with their spills,
   none allowed, and resident blocks per SM);
3. the NMS sweep kernel (a mask kernel and a scan kernel) against its plain
   version (``greedy_sweep_reference``): kept masks exactly equal over N in
   {1, 127, 128, 1000, 1024, 3000}, B in {1, 16}, iou/diou, xyxy/yxyx, with and
   without class-aware, on clustered boxes with tied scores, ineligible padding
   and zero-area boxes; then the sweep's times at N = 1024, B = 1 and 16
   (class-aware diou xyxy; 200 kernel calls back to back by CUDA events, which
   include the wrapper's host work, and one call of the plain host loop), its device
   time and each stage's by CUDA-graph replay, and the sweep's bound on that
   input;
4. the YOLOv4 slice in f32 with TF32 off: the batched predictor with the kernel
   and with the plain sweep give identical detections, and the card's heads
   agree with the CPU forward of the same state_dict (tolerance 1e-4·max|ref|);
5. YOLOv4 serving: the port's server (``tmv_tpu_torch.cli.serve.build_app``,
   bf16) answers 10 seeded JPEGs; every request goes through the NMS kernel;
6. YOLOv4 numbers: b1 image→boxes p50 and b16 images/sec (bf16 @640), the served
   p50, and the stage times (H2D, forward, post-process, D2H, whole) at b1 and
   b16 in bf16 and in f32 with TF32 off;
7. the depthwise kernel against its plain version (``dw_bn_swish_reference``) at
   all 12 D0 @512 depthwise shapes at B = 1 and 16 and at edge shapes (ragged
   8 x 8 tiles and 32-channel chunks, C in {4, 6, 24, 144, 240}), in f32
   (TF32 off; tolerance 1e-5·max|plain|) and bf16 (one bf16 step of the plain
   value plus 1e-5·max|plain|); then at each shape, B = 1 and 64, bf16: the
   kernel's time, the plain version's, the stock cuDNN route's (``library_ms``,
   never called by the port) and the bound, and at B = 1, where calls back to
   back time the host, the kernel's and the library's device time by CUDA-graph
   replay;
8. the D0 slice in f32 with TF32 off, B = 4: detections identical with the NMS
   kernel and with the plain sweep, at least one box per image, the pre-NMS
   candidates filled, and the card's heads within 1e-4·max|ref| of the CPU forward;
9. D0 serving: the port's server built with ``--family efficientdet --bf16
   --imageSize 512`` answers 10 seeded JPEGs; every forward launches the
   depthwise kernel 16 times and every request the NMS kernel;
10. D0 numbers: b1 image→boxes p50 and b64 images/sec (bf16 @512), the served
    p50, and the stage times at b1 and b64;
11. YOLOv4 training (80 classes @416 b8, bf16 activations on float32 master
    weights) on 64 synthetic JPEGs of ``tools/e2e_converged_map.py::make_dataset``:
    ``tmv_tpu_torch.cli.train_yolo`` takes two epochs of 10 steps with checkpoints
    and a val mAP per epoch (through the NMS kernel); then the step's time by
    CUDA events, its parts (forward, loss, backward, optimizer), one step alone
    between synchronisations, its kernels' device time (torch.profiler), the
    data pipeline's host and device time and
    the peak memory; an overfit of one fixed batch (30 steps must halve the raw
    loss); one float32 step (TF32 off) on the card and on the CPU from one
    state_dict and batch at B = 2, each held against the CPU's float64 step; and
    a resume from the CLI's last checkpoint (step and Adam state continue);
12. eval: ``tmv_tpu_torch.cli.eval_map`` in both modes on that checkpoint
    (the set's labels) and on a ``.pt`` of the seeded serving weights (labels
    made from their own detections: mAP strictly between 0 and 1), with the NMS
    kernel and again with the plain sweep patched in (one prediction pass per
    model, both modes scored from it): equal mAPs and identical kept sets, and the
    kernel's launches counted;
13. EfficientDet-D0 training (81 classes @512 b16, bf16 activations on float32
    master weights) on the same 64 JPEGs: ``tmv_tpu_torch.cli.train_efficientdet
    --deviceAug`` takes two epochs of 10 steps with checkpoints (no hand-written
    kernel launches in training); then the step's time by CUDA events, its parts
    (forward, loss, backward, SGD with the clip, EMA), one step alone, its
    kernels' device time (torch.profiler) and busy share, the pipeline's host
    and device time and the peak memory; an overfit of one fixed batch (30 steps
    at lr 0.05 must halve the raw loss); one float32 step (TF32 off,
    ``survival_prob`` 1) on the card and on the CPU against the CPU's float64
    step, by phase 11's rule; and a resume (step, SGD momentum and EMA continue);
14. D0 eval: ``tmv_tpu_torch.cli.eval_map --family efficientdet`` in both modes,
    f32 with TF32 off, on phase 13's checkpoint and on phase 8's seeded weights
    (foreground predict biases spread over [0.5, 1.5), so that scores do not tie)
    against labels made from their own detections (mAP strictly between 0 and
    1), through both kernels (16 depthwise launches per forward, one sweep per
    batch, counted), then with the plain sweep (identical kept rows, equal mAPs)
    and with the plain sweep and the plain depthwise (kept rows of the same count
    and classes, boxes within 1e-3 px, scores within 1e-5, equal mAPs), each plain
    re-run one prediction pass per model with both modes scored from it;
15. the YOLOv3 and ResNetYoloV3 slices (80 classes @416, f32 with TF32 off,
    B = 4, IoU NMS): detections identical with the NMS kernel and with the plain
    sweep, the sweeps' whole kept masks over the pre-NMS top 1024 identical too,
    the sweep suppressing candidates in every image (it keeps fewer than are
    eligible; the output's 500-row cap would hide that), and the card's heads
    within 1e-4·max|ref| of the CPU forward;
16. YOLOv3 serving: the port's server with ``--version v3 --bf16 --imageSize
    416`` answers 10 seeded JPEGs through the NMS kernel; the b1 image→boxes
    p50, the b16 images/s, the served p50 and the stage times at b1 and b16;
17. YOLOv3 from Darknet weights: the seeded v3 written as a ``.weights`` stream
    (``save_darknet_weights``), converted by ``cli/convert_darknet.py`` into a
    checkpoint directory that loads back to the same state_dict exactly;
    ``cli/train_yolo.py --version v3 --bf16 --darknetWeights … --warmupSteps
    5`` for two epochs of 5 steps at b8 @416 (after the warm-up every
    parameter outside ``DarknetConv_0/1/2`` is bit-equal to the stream, the
    output convs and every BatchNorm statistic have moved; the main phase starts
    at step 0 with a fresh Adam); an overfit of one fixed batch (30 steps must
    halve the raw loss); one float32 step against float64 by phase 11's rule;
    ``cli/eval_map.py --version v3`` in both modes on the trained and on the
    converted checkpoint directory (its own labels: mAP strictly between 0 and
    1), kernel and plain sweep (equal mAPs, identical kept rows, identical whole
    sweep masks, and suppressions on the converted checkpoint); and the port's
    server on the trained checkpoint directory answering one request;
18. YOLOv4 @608 with mosaic (80 classes, the COCO anchors scaled by 608/416):
    ``cli/train_yolo.py --imageSize 608 --mosaic 1.0 --cacheDir … --bf16`` for two
    epochs of 5 steps at b8 with a val pass per epoch through the NMS kernel
    (launches counted), no image decoded again once cached; two passes over the
    whole set through the cache (the second decodes nothing and its frames and
    labels equal uncached staging), the host staging time of a batch decoding
    and from the cache; ``mosaic_batch`` on the card against the CPU for one set
    of draws (boxes, classes, valid identical, pixels within one uint8 step);
    the step by CUDA events, its kernels' device time (torch.profiler) and its
    peak memory without and with ``--remat`` (remat must lower the peak), and
    one float32 step (TF32 off, deterministic
    cuDNN) with remat against the step without it run twice (within 2x that
    spread + 1e-6);
19. UNet @128 through ``cli/train_unet.py`` at the CLI's defaults (depth 4,
    width 16, 4 points, b4, float32) on 16 synthetic labelme quads the script
    writes: 10 steps with the dumps and checkpoints of two windows and a resume;
    the step by CUDA events, its kernels' device time and its peak memory at
    widths 16 and 64; an overfit
    of one fixed batch (30 steps at lr 1e-2 must halve the loss); one float32
    step on the card and on the CPU against the CPU's float64 step by phase
    11's rule;
20. the serving leftovers: ``tmv_tpu_torch.serving.wsgi:application`` built from
    the ``TMV_*`` environment (bf16, cuda) on phase 18's checkpoint directory (6
    requests through the NMS kernel) and on phase 13's D0 directory (4 requests,
    16 depthwise launches each), and ``cli/detect.py`` (float32) writing its
    image for both;
21. FaceNet (no hand-written kernel on its path; the phase checks that neither
    counter moves): on 12 synthetic people x 8 JPEGs (250 x 250) and an LFW-format
    tree (10 people x 6, a ``pairs.txt`` of 60 pairs, half same): the eval
    embeddings of InceptionResNetV1 @160 (embedding 512, float32, seeded) by
    ``get_embeddings`` at b30 and the b30 forward by CUDA events, the card
    against the CPU on 4 images (1e-4·max|CPU|, TF32 off) and unit norms within
    1e-5, the same for InceptionResNetV2, InceptionV4 and RepVGG-B2g4, and
    RepVGG-B2g4's deploy model (``repvgg_convert_params``) against its train
    model at JAX's test tolerance; ``select_triplets`` at the CLI's defaults (P =
    45, I = 40, n = 1800, D = 512): its time and peak memory, and one CPU Gumbel
    draw mined on the card and on the CPU, equal away from the borderline pairs;
    ``cli/train_facenet.py`` (b30, 2 epochs of 1 outer step, the LFW flags) with
    its outer step split into load, embed, mine and steps; the step (10
    triplets) by CUDA events, its kernels' device time, a warm step's peak and
    the memory its forward keeps for the backward, without and with ``--remat``
    (which must keep less); an overfit of one batch (5x or 0 in 30 steps); a float32
    step against float64 by phase 11's rule; a resume (weights equal the
    checkpoint, the step continues); one step each with ADAGRAD, ADADELTA and
    RMSPROP; ``cli/validate_on_lfw.py`` (its four lines; the accuracy equals
    ``lfw.evaluate`` on recomputed embeddings) and ``cli/facenet_distance.py``
    (symmetric, zero diagonal, the embeddings' squared distances);
22. MoCo and distillation on ResNetYoloV3 @416, float32 (TF32 off), on phase
    11's 64 JPEGs: ``cli/train_moco.py`` pretrain at b8, ``--outFilters 21``, K =
    100 (D = 74,529) for 20 steps with a checkpoint (step, queue and pointer), a
    resume for 2 more (the step, the pointer, the 16 written queue rows and the
    key tower continue; the other rows stay), ``export_k`` (the key tower,
    weights only) and ``finetune`` for 5 steps (exactly the output convs' 6
    tensors skipped by the graft); the MoCo step by CUDA events and in parts
    (key forward, query forward and loss, backward, SGD, momentum blend,
    enqueue), its kernels' device time and busy share, its peak above the
    resident state; one float32 step on the card and on the CPU against the
    CPU's float64 step at B = 2 by phase 11's rule (loss, gradients, blended
    key tower, written queue rows) and a wrapping push equal on card and CPU;
    ``cli/train_distill.py`` train_teacher (5 steps) and promote (the teacher
    = the student), with neither kernel launched on the MoCo and teacher paths;
    then dump_labels and train_students (5 steps) with the seeded ResNetYoloV3
    of phase 15 as the teacher (box rows scaled): one sweep launch per labeler
    call, every sweep's whole kept mask equal to the plain sweep's and with
    suppressions, the dumped file identical with the plain sweep's, a box in
    every pseudo-label batch; the labeler's forward and post-process per b8
    batch, the student step and the dump's images/s;
23. int8 (~30 s): the seeded YOLOv4 @640 (phase 4's weights, bf16) served by
    ``cli/serve.py --int8Static DIR --int8PerChannel`` (16 scene JPEGs calibrate it)
    at ``--batch`` 1 and 16 and by ``--int8`` at b1 (10 b1 requests one at a time, 32
    b16 requests from 16 clients at once), 107
    ``int8_conv`` launches per forward; the forward's b1 p50 and b16 images/s by
    CUDA events against the same model in bf16, and the share of bf16's kept boxes
    that int8 keeps (printed, not gated); every distinct ``int8_conv`` /
    ``int8_dwconv`` call of a YOLOv4 b1 per-channel forward and of a D0 @512 b1
    per-tensor forward, again in f32 per-tensor, and edge cases (Cin = 3, Cout 32,
    64 and 255, ragged Cout, K and M tiles, odd H and W at stride 2, H = W = 1, k = 5
    depthwise at both strides; f32 and bf16, per-tensor and per-channel) against the
    plain versions: int32 accumulators identical, outputs within 1e-6·max|plain|;
    ``int8_conv``'s quantize pass alone over the b1 and b16 forwards' calls (device
    ms, and the host's cost of one launch); ``cli/eval_map.py --int8Static
    --int8PerChannel`` on phase 11's checkpoint and ``--family efficientdet
    --int8Static`` on phase 13's (``int8_dwconv`` launched, ``dwconv_bn_swish``
    not); the kernels' times summed over one YOLOv4 b16 forward (107
    ``int8_conv``) and one D0 b64 forward (70 ``int8_dwconv``) beside their plain
    versions, the library route (quantize + int8 im2col + ``torch._int_mm`` +
    dequant; cuDNN's f32 grouped conv of the int8 values for the depthwise),
    cuDNN's bf16 convs of the same shapes and the bound, and the slowest five
    ``int8_conv`` launches beside cuDNN's bf16. An ``int8_conv`` call is two launches
    on the card (the quantize pass and the GEMM), counted once;
24. export (~60 s): ``cli/export_model.py`` writes three artifacts from the seeded
    weights of phases 4 and 8: YOLOv4 @640 bf16 (the JAX server's thresholds), the
    same with ``--int8Static --int8PerChannel`` (phase 23's 16 calibration scenes) and
    D0 @512 bf16; each program must hold exactly the ``tmv::`` ops of its live path
    (``nms_sweep``; + 107 ``int8_conv``; + 16 ``dw_bn_swish``); ``serve --artifact``
    loads it on the card and answers 6 seeded JPEGs; on one prepared scene the
    artifact equals the live predictor the same flags build (valid rows and ids
    equal, boxes and scores within one bf16 step + 1e-5·max|live|, the same kernel
    launches); then the YOLOv4 artifact runs once on the host's CPU (plain
    versions: no counter moves; at least 0.9 of each side's kept boxes found on the
    other, same class at IoU >= 0.5). Printed: export seconds and MB, load and
    warm-up seconds, the artifact's b1 forward p50 beside the live one by CUDA
    events, and the host's cost to enqueue one ``int8_conv`` through the
    ``tmv::int8_conv`` op and directly;
25. data parallel (``tmv_tpu_torch/parallel/``; at most ~120 s): two gloo ranks
    sharing the card take the YOLOv4 @416 f32 step on their b4 halves, held to the
    plain b8 step (``tests/dp_equiv_cases.py``'s YOLO tolerances: loss rel 2e-3,
    parameters rtol 1e-3 + atol 5e-4); ``cli/train_yolo.py`` @416 global b8 f32 for 2
    steps plain, ``--dp`` (with its val pass through the sweep kernel) and ``--fsdp``
    at world ``device_count()`` by NCCL: the first step's loss within 1e-5 of plain's,
    the later losses and the parameters' update within 2x + 1e-4 of the distance
    between two plain runs with different cuDNN algorithms (Adam's sign-sized first
    steps amplify rounding); ``cli/train_efficientdet.py`` @512 global b16 f32 2 steps
    ``--fsdp`` against ``--dp`` (losses and update within 1e-3), the ``--fsdp``
    checkpoint served by ``serve --family efficientdet`` and scored by ``eval_map``;
    ``serve --dp``'s sharded predictor over ``[cuda:0, cuda:0]`` for YOLOv4 @640 b16
    (float and ``--int8Static --int8PerChannel``) and D0 @512 b64, bf16: every sweep's
    whole mask equal to the plain sweep's, every depthwise launch within one bf16 step
    of the plain version, detections against the one-device predictor at >= 0.98 each
    way; ``serve --dp 1`` answers 6 requests and ``serve --dp 2`` on a one-card host
    exits with the reason; readings: the YOLOv4 step and the D0 step (bf16) plain, DP
    and FSDP at world 1 by CUDA events, the global BatchNorm's share
    (the DP step with rank-local statistics), FSDP's peak memory, and two replicas'
    images/s beside one's;
26. the spatial axis (``parallel/spatial.py``, ``parallel/halo.py``; at most ~60 s):
    ``serve --spatial 2`` over ``[cuda:0, cuda:0]`` for YOLOv4 @640 bf16, its
    ``--int8Static --int8PerChannel`` twin and D0 @512 bf16, 4 b1 requests each
    through the HTTP app; the letterboxed frames the server predicted are run again
    through the unsharded predictor of the same module: every sweep's whole mask
    equal for the int8 twin and D0, and for YOLOv4 in bf16 (whose cuDNN convs sum in
    another order at a shard's shapes) the detections at >= 0.98 each way (phase 25's
    rule for serve --dp) and the same frames' whole masks equal through float32
    predictors (TF32 off) of the weights; each kernel sweep equal to the plain sweep;
    every depthwise launch (on halo-padded shards) within one bf16 step of the plain
    version, and every distinct int8 call held to the plain versions as in phase 23;
    the served p50 and the b1
    predictor's p50 height-sharded beside unsharded; meanwhile ``train_yolo --sp 2``
    runs in two gloo ranks sharing the card (data 1 x space 2), YOLOv4 @416 global b8
    f32 (TF32 off, cuDNN deterministic) 2 steps, held to phase 25's plain run by its
    rules (first loss within 1e-5, the first gradients within 2x the plain run's
    distance from float64 + 1e-4, later losses within 1e-2).

Every phase prints ``phase N took X s`` and the last summary line the whole run's
seconds. Two groups of phases that read nothing the others write run in a process of
their own (``Side``) beside the main sequence, on the same card and host: 15-17
(YOLOv3), 19 (UNet) and 21 (FaceNet) beside 12-14, and 24 (export) beside 18, 20 and
22; the readings of phases 12-22 and 24 are taken on a shared card and host. Phases
1-11, 23 (whose int8 times go into the kernels line), 25 and 26 run alone.

The serving weights are seeded (``--randomInit --seed 0`` of each family), adjusted so
that NMS has real work: YOLOv4's three output convs' box rows are scaled by
1e-4 (unscaled, the heads reach |z| ~ 1e4 at 640 and decode to no valid box),
YOLOv3's and ResNetYoloV3's by the power of ten that brings a seeded image's
largest box logit to at most 1 (phase 15 prints it);
D0's class predict bias is raised from the focal prior −4.6 to +1.0 for the 80
foreground classes (at −4.6 every raw logit stays below the 1e-4 threshold and
nothing enters NMS). The card's name and power limit stand beside every number.
The line before the last is the card; the line before it the kernels' JSON. The
last line is ``{"ok": true, "device": {...}}``; any failure raises and exits
non-zero, and without a CUDA device nothing is run.
"""

import base64
import contextlib
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
IMAGE = 640
D0_IMAGE = 512
TRAIN_IMAGE = 416
TRAIN_BATCH = 8
TRAIN_STEPS_PER_EPOCH = 10
TRAIN_SET = 64
VAL_SET = 16
OVERFIT_STEPS = 30
MOSAIC_IMAGE = 608
MOSAIC_STEPS_PER_EPOCH = 5
UNET_SET = 16
UNET_STEPS = 10
D0_TRAIN_BATCH = 16
V3_IMAGE = 416
V3_STEPS_PER_EPOCH = 5
V3_WARMUP = 5
V3_PREDICT_KW = dict(confidence_thresh=0.5, scores_thresh=0.2, iou_thresh=0.5, iou_type="iou")
D0_OVERFIT_LR = 0.05
FACE_IMAGE = 160
FACE_EMBEDDING = 512
FACE_BATCH = 30
FACE_PEOPLE = 12
FACE_IMAGES = 8
LFW_PEOPLE = 10
LFW_IMAGES = 6
LFW_PAIRS = 60
MINING_PEOPLE = 45
MINING_IMAGES = 40
MOCO_FILTERS = 21
MOCO_QUEUE = 100
MOCO_DIM = (13 ** 2 + 26 ** 2 + 52 ** 2) * MOCO_FILTERS    # at 416
MOCO_STEPS = 20
FINETUNE_STEPS = 5
TEACHER_STEPS = 5
STUDENT_STEPS = 5
NMS_SOURCE = "tmv_tpu_torch/csrc/nms_sweep.cu"
NMS_REPLACES = "tmv_tpu/kernels/nms_pallas.py:90"
DW_SOURCE = "tmv_tpu_torch/csrc/dwconv_bn_swish.cu"
DW_REPLACES = "tmv_tpu/kernels/dwconv_pallas.py:110"   # _fused_s1; _fused_s2 at :170
INT8_SOURCE = "tmv_tpu_torch/csrc/int8_conv.cu"
# XLA's int8 conv_general_dilated (preferred_element_type=int32): the JAX package has
# no Pallas kernel there; the dynamic path's is at tmv_tpu/quant/dynamic.py:85
INT8_REPLACES = "tmv_tpu/quant/static.py:212"
# phase 23's served readings: b1 requests one at a time, b16 requests from 16 clients
SERVED_B1_REQUESTS = 10
SERVED_B16_REQUESTS = 32
PREDICT_KW = dict(confidence_thresh=0.5, scores_thresh=0.2, iou_thresh=0.5, iou_type="diou")
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
INT8_OPS_PER_S = 1979e12
# operations of one class-aware xyxy DIoU pair in the sweep (compare, class
# test, intersection, areas, union, division, enclosing box, centres, the
# 0.6 power as log/mul/exp, threshold)
SWEEP_OPS_PER_PAIR = 46
# Every depthwise shape of EfficientDet-D0 @512: (input H=W, C, k, stride) → blocks.
D0_DW_SHAPES = {(256, 32, 3, 1): 1, (256, 96, 3, 2): 1, (128, 144, 3, 1): 1,
                (128, 144, 5, 2): 1, (64, 240, 5, 1): 1, (64, 240, 3, 2): 1,
                (32, 480, 3, 1): 2, (32, 480, 5, 1): 1, (32, 672, 5, 1): 2,
                (32, 672, 5, 2): 1, (16, 1152, 5, 1): 3, (16, 1152, 3, 1): 1}
# (B, H, W, C, k, stride): odd sizes at stride 2, H = W = 1, a C the 4-vector
# misses, and H, W, C that cut the kernel's 8 x 8 pixel x 32 channel tiles raggedly
DW_EDGE_CASES = [(1, 15, 9, 4, 3, 1), (1, 13, 11, 4, 5, 2), (5, 15, 9, 4, 3, 1),
                 (3, 17, 17, 24, 3, 2), (2, 1, 1, 8, 3, 2), (2, 1, 1, 8, 5, 1),
                 (2, 9, 7, 6, 5, 1), (2, 9, 7, 6, 3, 2), (1, 19, 21, 144, 5, 1),
                 (2, 23, 17, 240, 3, 2), (1, 1, 1, 240, 5, 1), (3, 9, 10, 24, 5, 2),
                 (1, 31, 29, 144, 5, 2), (2, 10, 9, 4, 5, 1), (1, 33, 35, 6, 5, 2)]
YOLO_NAMES = {"v4": "YOLOv4", "v3": "YOLOv3", "resnet": "ResNetYoloV3"}
COCO_CLASSES = (
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train", "truck", "boat",
    "traffic light", "fire hydrant", "stop sign", "parking meter", "bench", "bird", "cat",
    "dog", "horse", "sheep", "cow", "elephant", "bear", "zebra", "giraffe", "backpack",
    "umbrella", "handbag", "tie", "suitcase", "frisbee", "skis", "snowboard", "sports ball",
    "kite", "baseball bat", "baseball glove", "skateboard", "surfboard", "tennis racket",
    "bottle", "wine glass", "cup", "fork", "knife", "spoon", "bowl", "banana", "apple",
    "sandwich", "orange", "broccoli", "carrot", "hot dog", "pizza", "donut", "cake", "chair",
    "couch", "potted plant", "bed", "dining table", "toilet", "tv", "laptop", "mouse",
    "remote", "keyboard", "cell phone", "microwave", "oven", "toaster", "sink",
    "refrigerator", "book", "clock", "vase", "scissors", "teddy bear", "hair drier",
    "toothbrush",
)


def check(ok, message):
    if not ok:
        raise RuntimeError(f"chip_smoke: {message}")


def run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, reps):
    """Mean device milliseconds of ``fn`` over ``reps`` back-to-back calls."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps):
    """Median host milliseconds of ``fn`` between two synchronisations."""
    import torch

    samples = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        samples.append((time.perf_counter() - t0) * 1000)
    return statistics.median(samples)


def graph_ms(fn, reps=20, per_graph=10):
    """Device milliseconds of one ``fn`` call: ``per_graph`` calls captured in a
    CUDA graph, the graph replayed ``reps`` times between CUDA events. The host
    work of the call (the wrapper's checks, ``ctypes``) is left out, so this is
    the kernels' time where ``cuda_ms`` of back-to-back calls is bound by the
    host."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    return cuda_ms(graph.replay, reps) / per_graph


def turns(plain, kernel, plain_reps, kernel_reps):
    """(kernel ms, plain ms, the four turns) timed plain, kernel, kernel, plain."""
    t = [cuda_ms(plain, plain_reps), cuda_ms(kernel, kernel_reps),
         cuda_ms(kernel, kernel_reps), cuda_ms(plain, plain_reps)]
    return (t[1] + t[2]) / 2, (t[0] + t[3]) / 2, t


def write_atomic(path, data):
    """``data`` (bytes) into ``path`` through a renamed temporary file: a phase in
    another process that reads it meanwhile sees the whole old or new file."""
    temporary = f"{path}.{os.getpid()}.tmp"
    with open(temporary, "wb") as f:
        f.write(data)
    os.replace(temporary, path)


def write_inputs(classes, anchors=None):
    """Classes file (and YOLO anchors file) for the serving CLI."""
    classes_file = os.path.join(WORK, "coco_classes.txt")
    write_atomic(classes_file, ("\n".join(classes) + "\n").encode())
    if anchors is None:
        return classes_file, None
    anchors_file = os.path.join(WORK, "coco_anchors.txt")
    write_atomic(anchors_file, ",".join(str(int(v)) for v in anchors[::-1].reshape(-1)).encode())
    return classes_file, anchors_file


# ---------------------------------------------------------------- inputs

def sweep_case(rng, n, batch, coord):
    """Score-sorted sweep inputs: clustered boxes (10% zero-area), scores on a
    1/8 grid (ties), the last 10% of each row ineligible padding, 3 classes."""
    centers = rng.uniform(10, 90, (batch, n // 4 + 1, 2))
    pick = rng.integers(0, n // 4 + 1, (batch, n))
    c = np.take_along_axis(centers, pick[..., None], 1) + rng.normal(0, 3, (batch, n, 2))
    wh = rng.uniform(5, 25, (batch, n, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1)
    flat = rng.uniform(size=(batch, n)) < 0.1
    boxes[..., 2] = np.where(flat, boxes[..., 0], boxes[..., 2])
    scores = np.round(rng.uniform(0, 1, (batch, n)) * 8) / 8
    valid = rng.uniform(size=(batch, n)) > 0.1
    valid[:, n - n // 10:] = False
    order = np.argsort(-np.where(valid, scores, -np.inf), axis=1, kind="stable")
    boxes = np.take_along_axis(boxes, order[..., None], 1)
    if coord == "yxyx":
        boxes = boxes[..., [1, 0, 3, 2]]
    eligible = np.take_along_axis(valid & (scores >= 0.25), order, 1)
    classes = rng.integers(0, 3, (batch, n))
    return np.ascontiguousarray(boxes, np.float32), eligible, classes.astype(np.int32)


def scene_jpeg(rng, height, width):
    """A seeded synthetic photo: gradient, coloured rectangles, mild noise."""
    from PIL import Image

    y, x = np.mgrid[0:height, 0:width]
    img = np.stack([x * 255 // width, y * 255 // height, (x + y) * 127 // (width + height)], -1)
    for _ in range(6):
        h, w = rng.integers(height // 8, height // 2), rng.integers(width // 8, width // 2)
        top, left = rng.integers(0, height - h), rng.integers(0, width - w)
        img[top:top + h, left:left + w] = rng.integers(0, 256, 3)
    img = np.clip(img + rng.normal(0, 8, img.shape), 0, 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=90)
    return buf.getvalue()


def dw_inputs(gen, b, h, w, c, k, dtype):
    """Seeded depthwise inputs made on the card: channels_last activations,
    taps ~ N(0, 0.3²), scale in [0.5, 1.5), offset ~ N(0, 0.1²)."""
    import torch

    x = torch.randn((b, h, w, c), generator=gen, device="cuda").permute(0, 3, 1, 2)
    x = x.to(dtype).contiguous(memory_format=torch.channels_last)
    taps = torch.randn((k, k, c), generator=gen, device="cuda") * 0.3
    scale = torch.rand((c,), generator=gen, device="cuda") + 0.5
    offset = torch.randn((c,), generator=gen, device="cuda") * 0.1
    return x, taps, scale, offset


def within_one_bf16_step(got, want):
    """|got − want| ≤ one bfloat16 step at |want| + 1e-5·max|want|, elementwise:
    the float32 tolerance stays under the step, because where the k² sum cancels
    to near 0 the two float32 sums differ by more than a step of their result."""
    import torch

    want = want.float()
    _, exponent = torch.frexp(want.abs())
    step = torch.ldexp(torch.ones_like(want), exponent - 8)
    tol = step + 1e-5 * want.abs().max()
    return bool(((got.float() - want).abs() <= tol).all())


# ---------------------------------------------------------------- phases

def phase_environment():
    import torch

    from tmv_tpu_torch.kernels.build import nvcc_path

    nvcc = run([nvcc_path(), "--version"]).splitlines()[-1]
    card = run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    card = card.splitlines()[0]
    print(f"phase 1 environment: python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, nvcc [{nvcc}], card [{card}], "
          f"{torch.cuda.device_count()} device(s)", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("phase 1 environment: torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False (f32 is compared in full f32)", flush=True)
    return card


def ptxas_entries(log):
    """(kernel, integer template arguments, registers, static shared bytes) of
    each ``*_kernel`` entry function in an ``nvcc -Xptxas -v`` log."""
    entries, name = [], None
    for line in log.splitlines():
        found = re.search(r"Compiling entry function '\w*?(\d+)([a-z_]+_kernel)(\w*)'", line)
        if found:
            name = (found.group(2), re.findall(r"L[ib](\d+)E", found.group(3)))
        used = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if used and name:
            entries.append((*name, int(used.group(1)), int(used.group(2) or 0)))
            name = None
    return entries


def phase_build(card):
    import torch

    from tmv_tpu_torch.kernels import dwconv, int8_conv, nms_sweep

    libraries = {NMS_SOURCE: nms_sweep.LIBRARY, DW_SOURCE: dwconv.LIBRARY,
                 INT8_SOURCE: int8_conv.LIBRARY}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libraries)) as pool:
        for future in [pool.submit(lib.load) for lib in libraries.values()]:
            future.result()
    wall = time.perf_counter() - t0
    for source, lib in libraries.items():
        print(f"phase 2 build: {source} -> sm_90a in {lib.seconds:.2f} s on [{card}]", flush=True)
    for kernel, args, regs, smem in ptxas_entries(nms_sweep.LIBRARY.log):
        what = (f"variant {args[0]}, class-aware {args[1]}" if len(args) == 2 else
                f"dynamic shared memory N x ceil(N/64) x 8 bytes per block where it fits "
                f"({1024 * 16 * 8} at N = 1024)")
        print(f"phase 2 build: nms {kernel} ({what}): {regs} registers per thread, "
              f"{smem} bytes static shared memory per block (ptxas) on [{card}]", flush=True)
    max_k5 = 0
    for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for k in (3, 5):
            for stride in (1, 2):
                info = dwconv.kernel_info(k, stride, dtype)
                print(f"phase 2 build: dwconv {name} k={k} s={stride}: {info['registers']} "
                      f"registers per thread, {info['smem_bytes']} bytes shared memory per "
                      f"block, {info['spill_bytes']} bytes spilled, {info['blocks_per_sm']} "
                      f"resident blocks of {info['threads']} threads per SM on [{card}]",
                      flush=True)
                check(info["spill_bytes"] == 0, f"dwconv {name} k={k} s={stride} spills")
                if k == 5:
                    max_k5 = max(max_k5, info["registers"])
    check(max_k5 <= 128, f"a k = 5 depthwise instantiation uses {max_k5} registers")
    int8_infos = [(f"int8_conv GEMM BN={block_n}", int8_conv.kernel_info("gemm", block_n=block_n))
                  for block_n in int8_conv.BLOCK_NS]
    for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        int8_infos.append((f"int8_conv quantize {name}",
                           int8_conv.kernel_info("quantize", dtype=dtype)))
        for k, stride in sorted(int8_conv.DW_ROUTES):
            int8_infos.append((f"int8_dwconv {name} k={k} s={stride}",
                               int8_conv.kernel_info("dwconv", dtype=dtype, k=k, stride=stride)))
    for what, info in int8_infos:
        print(f"phase 2 build: {what}: {info['registers']} registers per thread, "
              f"{info['smem_bytes']} bytes shared memory per block, {info['spill_bytes']} bytes "
              f"spilled, {info['blocks_per_sm']} resident blocks of {info['threads']} threads per "
              f"SM on [{card}]", flush=True)
        check(info["spill_bytes"] == 0, f"{what} spills")
    print(f"phase 2 build: the three kernel sources built in parallel in {wall:.2f} s on "
          f"[{card}]", flush=True)


def sweep_bound_ms(boxes, eligible, classes, iou_threshold):
    """Least time of one class-aware xyxy DIoU sweep on this input: the larger
    of its bytes (boxes, eligible and classes read once, kept written once) over
    the HBM rate and the IoU operations the greedy order needs (each kept box
    against every later unsuppressed box of its class) over the f32 rate."""
    import torch

    from tmv_tpu_torch.ops.iou import iou_xyxy

    boxes, eligible, classes = (torch.from_numpy(a[0]) for a in (boxes, eligible, classes))
    n = boxes.shape[0]
    suppressed = torch.zeros(n, dtype=torch.bool)
    pairs = 0
    for i in range(n):
        if suppressed[i] or not eligible[i]:
            continue
        later = ~suppressed[i + 1:] & (classes[i + 1:] == classes[i])
        pairs += int(later.sum())
        hit = iou_xyxy(boxes[i:i + 1], boxes[i + 1:], iou_type="diou") >= iou_threshold
        suppressed[i + 1:] |= hit & later
    bytes_ms = n * (16 + 1 + 4 + 1) / HBM_BYTES_PER_S * 1e3
    ops_ms = pairs * SWEEP_OPS_PER_PAIR / F32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations", pairs


def phase_kernel(card):
    import torch

    from tmv_tpu_torch.kernels.nms_sweep import (
        greedy_sweep, greedy_sweep_reference, scan, suppression_mask,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    cases, max_err, kept_total = 0, 0, 0
    for n in (1, 127, 128, 1000, 1024, 3000):
        for batch in (1, 16):
            for coord in ("xyxy", "yxyx"):
                boxes, eligible, classes = (torch.from_numpy(a).to(dev)
                                            for a in sweep_case(rng, n, batch, coord))
                for iou_type in ("iou", "diou"):
                    for cls in (None, classes):
                        got = greedy_sweep(boxes, eligible, cls, 0.5, iou_type, coord)
                        want = greedy_sweep_reference(boxes, eligible, cls, 0.5, iou_type, coord)
                        torch.cuda.synchronize()
                        err = int((got.int() - want.int()).abs().max())
                        check(err == 0, f"kernel != plain at N={n} B={batch} {coord} "
                                        f"{iou_type} class_aware={cls is not None}")
                        max_err = max(max_err, err)
                        kept_total += int(got.sum())
                        cases += 1
    print(f"phase 3 kernel vs plain: {cases} cases, kept masks exactly equal "
          f"(max |kernel - plain| = {max_err}, {kept_total} boxes kept in all) on [{card}]",
          flush=True)

    times, device, bound = {}, {}, None
    for batch in (1, 16):
        arrays = sweep_case(rng, 1024, batch, "xyxy")
        boxes, eligible, classes = (torch.from_numpy(a).to(dev) for a in arrays)

        def kernel():
            greedy_sweep(boxes, eligible, classes, 0.5, "diou", "xyxy")

        def plain():
            greedy_sweep_reference(boxes, eligible, classes, 0.5, "diou", "xyxy")

        kernel()
        # the plain sweep is a host loop (no yardstick): one call, after the kernel's
        times[batch] = (cuda_ms(kernel, 200), cuda_ms(plain, 1))
        mask = suppression_mask(boxes, classes, 0.5, "diou", "xyxy")
        device[batch] = {
            "sweep": graph_ms(kernel),
            "mask": graph_ms(lambda: suppression_mask(boxes, classes, 0.5, "diou", "xyxy")),
            "scan": graph_ms(lambda: scan(mask, eligible))}
        print(f"phase 3 time N=1024 B={batch} class-aware diou xyxy on [{card}]: "
              f"calls back to back: kernel {times[batch][0]:.4f} ms (200 calls), plain "
              f"{times[batch][1]:.2f} ms (one call); device time "
              f"(CUDA graph): sweep {device[batch]['sweep']:.4f} ms = mask kernel "
              f"{device[batch]['mask']:.4f} ms + scan kernel {device[batch]['scan']:.4f} ms",
              flush=True)
        if batch == 1:
            bound = sweep_bound_ms(*arrays, 0.5)
            print(f"phase 3 bound N=1024 B=1: {bound[0]:.6f} ms, by {bound[1]} "
                  f"({bound[2]} IoU pairs x {SWEEP_OPS_PER_PAIR} operations at 67 TFLOP/s "
                  f"f32; {1024 * 22} bytes at 3.35 TB/s); no single PyTorch call computes "
                  f"the sweep (library_ms null)", flush=True)
    return max_err, times, device, bound


def seeded_model(dtype, device):
    """``--randomInit --seed 0`` weights with the output convs' box rows scaled."""
    import torch

    from tmv_tpu_torch.models.detector_harness import build_yolo_model
    from tmv_tpu_torch.models.layers.common import init_weights

    model, iou_type = build_yolo_model("v4", 80, dtype=dtype)
    init_weights(model, 0)
    with torch.no_grad():
        for head in (model.DarknetConv_0, model.DarknetConv_1, model.DarknetConv_2):
            rows = torch.arange(head.Conv_0.out_channels) % 85 < 4
            head.Conv_0.weight[rows] *= 1e-4
    return model.to(device=device, memory_format=torch.channels_last).eval(), iou_type


def phase_slice(card):
    import torch

    from tmv_tpu_torch.kernels.nms_sweep import greedy_sweep_reference
    from tmv_tpu_torch.models.detector_harness import make_yolo_predict_batched
    from tmv_tpu_torch.models.yolo_v4 import COCO_ANCHORS, YoloV4

    torch.backends.cudnn.deterministic = True
    model, iou_type = seeded_model(torch.float32, "cuda")
    check(iou_type == "diou", "YOLOv4 predicts with DIoU NMS")
    os.makedirs(WORK, exist_ok=True)
    weights = os.path.join(WORK, "yolov4_seed0.pt")
    torch.save({k: v.cpu() for k, v in model.state_dict().items()}, weights)

    rng = np.random.default_rng(1)
    images = rng.uniform(0, 1, (4, IMAGE, IMAGE, 3)).astype(np.float32)
    predict = make_yolo_predict_batched(model, (IMAGE, IMAGE), COCO_ANCHORS, 80, **PREDICT_KW)
    got = predict(None, images)
    with mock.patch("tmv_tpu_torch.ops.nms.greedy_sweep", greedy_sweep_reference):
        want = predict(None, images)
    for g, w, name in zip(got, want, ("boxes", "ids", "scores", "valid")):
        check(np.array_equal(g, w), f"slice {name} differ between kernel and plain sweep")
    boxes, ids, scores, valid = got
    check(boxes.shape == (4, 500, 4) and valid.shape == (4, 500), "predictor output shapes")
    check(valid.sum() > 0, "the slice kept no box")
    check(np.isfinite(boxes[valid]).all() and np.isfinite(scores[valid]).all(),
          "non-finite detections")
    check(((ids[valid] >= 0) & (ids[valid] < 80)).all(), "class ids out of range")
    print(f"phase 4 slice: YOLOv4 80 classes @{IMAGE} f32 B=4, kernel and plain sweep give "
          f"identical detections, kept per image {valid.sum(1).tolist()} on [{card}]", flush=True)

    with torch.inference_mode():
        card_heads = [h.float().cpu().numpy() for h in model(torch.from_numpy(images[:1]).cuda())]
        cpu_model = YoloV4(80).eval()
        cpu_model.load_state_dict(torch.load(weights, weights_only=True), strict=True)
        cpu_heads = [h.numpy() for h in cpu_model(torch.from_numpy(images[:1]))]
    rel = max(float(np.abs(g - w).max() / np.abs(w).max()) for g, w in zip(card_heads, cpu_heads))
    check(rel <= 1e-4, f"card heads differ from the CPU forward: {rel:.3g} of max|ref|")
    print(f"phase 4 slice: card heads vs CPU forward of the same state_dict: "
          f"max |diff| = {rel:.3g}·max|ref| (tolerance 1e-4) on [{card}]", flush=True)
    torch.backends.cudnn.deterministic = False
    return model, weights


@contextlib.contextmanager
def local_server(app, clients=0):
    """``app`` served on a free localhost port (a thread per request and a listen
    backlog for ``clients`` at once when ``clients``) → the predict URL; the
    server stops when the block ends."""
    import socketserver
    from wsgiref.simple_server import WSGIRequestHandler, WSGIServer, make_server

    class Quiet(WSGIRequestHandler):
        def log_message(self, *a):
            pass

    class Threaded(socketserver.ThreadingMixIn, WSGIServer):
        daemon_threads = True
        request_queue_size = 2 * clients

    server = make_server("127.0.0.1", 0, app, handler_class=Quiet,
                         server_class=Threaded if clients else WSGIServer)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}/ai_api/object_detection/predict"
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)


def drive_server(app, count, seed):
    """Serve ``app`` on a free localhost port, post ``count`` seeded JPEGs
    (read=1 and read=0 in turns, 375x500 … 1080x1920), check each answer, and
    return (latencies, latencies by read, boxes seen, kernel launches in the run).
    The launch counts are set to 0 just before the first request."""
    from tmv_tpu_torch.kernels import dwconv, int8_conv, nms_sweep

    rng = np.random.default_rng(seed)
    sizes = [(480, 640), (720, 1280), (640, 640), (375, 500), (1080, 1920)]
    latencies, by_read, boxes_seen = [], {0: [], 1: []}, 0
    with local_server(app) as url:
        nms_sweep.launches = dwconv.launches = 0
        int8_conv.launches.update(int8_conv=0, int8_dwconv=0)
        for i in range(count):
            h, w = sizes[i % len(sizes)]
            read = 1 if i % 2 == 0 else 0
            data = "data:image/jpeg;base64," + base64.b64encode(scene_jpeg(rng, h, w)).decode()
            body = json.dumps({"img_data": data, "read": read}).encode()
            request = urllib.request.Request(url, body, {"Content-Type": "application/json"})
            t0 = time.perf_counter()
            try:
                with urllib.request.urlopen(request, timeout=60) as resp:
                    status, out = resp.status, json.loads(resp.read())
            except urllib.error.HTTPError as e:
                raise RuntimeError(f"chip_smoke: request {i}: HTTP {e.code} "
                                   f"{e.read()[:2000]!r}") from e
            latencies.append((time.perf_counter() - t0) * 1000)
            by_read[read].append(latencies[-1])
            check(status == 200, f"request {i}: HTTP {status}")
            check(set(out) == {"boxes", "classes", "random_img", "result_img"},
                  f"request {i}: keys {sorted(out)}")
            check(len(out["boxes"]) == len(out["classes"]), f"request {i}: boxes/classes")
            check(bool(out["result_img"]) == bool(read), f"request {i}: read={read} images")
            boxes_seen += len(out["boxes"])
        launches = {"nms_sweep": nms_sweep.launches, "dwconv_bn_swish": dwconv.launches,
                    **int8_conv.launches}
    return latencies, by_read, boxes_seen, launches


def drive_server_concurrent(app, count, clients, seed):
    """Serve ``app`` on a threaded localhost server and post ``count`` seeded JPEGs
    (read=0, 480x640 … 1080x1920, encoded before the clock starts) from ``clients``
    threads at once, so that a batching server can fill its batches; check each
    answer → (seconds from the first post to the last answer, latencies, boxes seen,
    kernel launches in the run). The launch counts are set to 0 just before the
    first request."""
    from tmv_tpu_torch.kernels import dwconv, int8_conv, nms_sweep

    rng = np.random.default_rng(seed)
    sizes = [(480, 640), (720, 1280), (640, 640), (375, 500), (1080, 1920)]
    bodies = [json.dumps({"img_data": "data:image/jpeg;base64," + base64.b64encode(
        scene_jpeg(rng, *sizes[i % len(sizes)])).decode(), "read": 0}).encode()
        for i in range(count)]

    def post(url, i):
        request = urllib.request.Request(url, bodies[i], {"Content-Type": "application/json"})
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(request, timeout=120) as resp:
                status, out = resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as e:
            raise RuntimeError(f"chip_smoke: request {i}: HTTP {e.code} "
                               f"{e.read()[:2000]!r}") from e
        return (time.perf_counter() - t0) * 1000, status, out

    with local_server(app, clients) as url:
        nms_sweep.launches = dwconv.launches = 0
        int8_conv.launches.update(int8_conv=0, int8_dwconv=0)
        t0 = time.perf_counter()
        with ThreadPoolExecutor(clients) as pool:
            answers = list(pool.map(lambda i: post(url, i), range(count)))
        wall = time.perf_counter() - t0
        launches = {"nms_sweep": nms_sweep.launches, "dwconv_bn_swish": dwconv.launches,
                    **int8_conv.launches}
    boxes_seen = 0
    for i, (_, status, out) in enumerate(answers):
        check(status == 200, f"request {i}: HTTP {status}")
        check(set(out) == {"boxes", "classes", "random_img", "result_img"},
              f"request {i}: keys {sorted(out)}")
        check(len(out["boxes"]) == len(out["classes"]) and not out["result_img"],
              f"request {i}: boxes/classes/read=0")
        boxes_seen += len(out["boxes"])
    return wall, [ms for ms, _, _ in answers], boxes_seen, launches


def phase_serving(card, weights):
    from tmv_tpu_torch.cli import serve
    from tmv_tpu_torch.models.yolo_v4 import COCO_ANCHORS

    classes_file, anchors_file = write_inputs(COCO_CLASSES, COCO_ANCHORS)
    args = serve.parse_args(["--modelPath", weights, "--classesFile", classes_file,
                             "--anchorsFile", anchors_file, "--imageSize", str(IMAGE),
                             "--bf16", "--device", "cuda"])
    app, _, model = serve.build_app(args)
    check(all(p.device.type == "cuda" for p in model.parameters()), "model is not on cuda")
    latencies, by_read, boxes_seen, launches = drive_server(app, 10, 2)
    check(launches["nms_sweep"] >= len(latencies),
          f"{launches['nms_sweep']} NMS launches for {len(latencies)} requests")
    p50 = statistics.median(latencies)
    print(f"phase 5 serving: {len(latencies)} requests (read=1 and read=0, 375x500..1080x1920 "
          f"JPEGs) -> HTTP 200 with the reference keys, {boxes_seen} boxes; "
          f"nms_sweep.launches {launches['nms_sweep']}, dwconv.launches "
          f"{launches['dwconv_bn_swish']}; served p50 {p50:.2f} ms "
          f"(read=0 {statistics.median(by_read[0]):.2f} ms, boxes only; "
          f"read=1 {statistics.median(by_read[1]):.2f} ms, with the two JPEGs drawn and "
          f"encoded) (YOLOv4 bf16 @{IMAGE}, on [{card}])", flush=True)
    return model, launches, p50


def stage_times(images, predict, forward, post, reps):
    """Milliseconds per stage of a batched predictor on ``images``: H2D
    (pageable, as the predictor copies) and D2H of the four outputs on the host
    clock around a synchronised copy; forward and post-process (decode, pre-NMS
    top-k, NMS, gathers) by CUDA events over ``reps`` back-to-back calls; the
    whole predictor on the host clock. Medians of ``reps`` where the host clock
    is used."""
    import torch

    for _ in range(3):
        predict(None, images)
    with torch.inference_mode():
        x = torch.from_numpy(images).cuda()
        heads = forward(x)
        out = post(heads)
        return {"H2D": host_ms(lambda: torch.from_numpy(images).to("cuda"), reps),
                "forward": cuda_ms(lambda: forward(x), reps),
                "post-process": cuda_ms(lambda: post(heads), reps),
                "D2H": host_ms(lambda: [o.cpu() for o in out], reps),
                "whole": host_ms(lambda: predict(None, images), reps)}


def yolo_stage_times(model, batch, reps=20, size=IMAGE, predict_kw=PREDICT_KW):
    from tmv_tpu_torch.models.detector_harness import make_yolo_predict_batched
    from tmv_tpu_torch.models.yolo_v4 import COCO_ANCHORS
    from tmv_tpu_torch.ops.yolo import nms_boxes_batched

    images = np.random.default_rng(4).uniform(0, 1, (batch, size, size, 3)).astype(np.float32)
    predict = make_yolo_predict_batched(model, (size, size), COCO_ANCHORS, 80, **predict_kw)

    def post(heads):
        out = nms_boxes_batched(heads, COCO_ANCHORS, (size, size), 80, **predict_kw)
        return [out[i] for i in (0, 1, 2, 5)]

    return stage_times(images, predict, model, post, reps)


def yolo_speed(model, size, predict_kw):
    """(b1 image→boxes p50 ms over 50 runs, host numpy in and out; b16 batched
    predictor images/s over 10 batches), bf16 or as the model is."""
    from tmv_tpu_torch.models.detector_harness import (
        make_yolo_predict, make_yolo_predict_batched,
    )
    from tmv_tpu_torch.models.yolo_v4 import COCO_ANCHORS

    rng = np.random.default_rng(3)
    one = rng.uniform(0, 1, (1, size, size, 3)).astype(np.float32)
    sixteen = rng.uniform(0, 1, (16, size, size, 3)).astype(np.float32)
    predict = make_yolo_predict(model, (size, size), COCO_ANCHORS, 80, **predict_kw)
    batched = make_yolo_predict_batched(model, (size, size), COCO_ANCHORS, 80, **predict_kw)
    for _ in range(5):
        predict(None, one)
    latencies = []
    for _ in range(50):
        t0 = time.perf_counter()
        predict(None, one)                      # ends in a device-to-host copy
        latencies.append((time.perf_counter() - t0) * 1000)
    for _ in range(3):
        batched(None, sixteen)
    t0 = time.perf_counter()
    reps = 10
    for _ in range(reps):
        batched(None, sixteen)
    return statistics.median(latencies), 16 * reps / (time.perf_counter() - t0)


def phase_numbers(card, model, model_f32, served_p50):
    import torch

    b1, ips = yolo_speed(model, IMAGE, PREDICT_KW)
    print(f"phase 6 numbers on [{card}]: YOLOv4 80 classes bf16 @{IMAGE}: "
          f"b1 image->boxes p50 {b1:.2f} ms (host numpy in, host numpy out, 50 runs); "
          f"b16 batched predictor {ips:.1f} images/s; served p50 {served_p50:.2f} ms", flush=True)
    check(not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32,
          "TF32 must stay off for the f32 stage times")
    for name, m in (("bf16", model), ("f32, TF32 off", model_f32)):
        for batch in (1, 16):
            stages = yolo_stage_times(m, batch)
            print(f"phase 6 stages on [{card}]: YOLOv4 80 classes {name} @{IMAGE} b{batch}: "
                  + ", ".join(f"{k} {v:.2f} ms" for k, v in stages.items()), flush=True)
    return b1, ips


def dw_bound_ms(b, hw, c, k, stride, itemsize):
    """Least time of one depthwise launch: the larger of its bytes (input and
    output activations once, taps, scale and offset once) over the HBM rate and
    its operations (2k² per output for the taps, 2 for the affine, 4 for the
    swish: neg, exp, add, div) over the f32 rate."""
    out = -(-hw // stride)
    nbytes = (b * hw * hw * c + b * out * out * c) * itemsize + (k * k * c + 2 * c) * 4
    ops = b * out * out * c * (2 * k * k + 6)
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def library_dw(x, w, scale, offset, stride):
    """The stock route a PyTorch user would take, which the port never calls:
    ``F.conv2d(groups=C)`` (cuDNN; with ``F.pad`` first where TF-SAME pads
    asymmetrically), ``torch.addcmul`` for the affine and ``F.silu``, in the
    activations' dtype."""
    import torch
    import torch.nn.functional as F

    from tmv_tpu_torch.models.layers.common import same_pads

    c, k = x.shape[1], w.shape[0]
    weight = w.permute(2, 0, 1).unsqueeze(1).to(x.dtype).contiguous()
    top, bottom = same_pads(x.shape[2], k, stride)
    left, right = same_pads(x.shape[3], k, stride)
    scale, offset = scale.to(x.dtype).view(1, c, 1, 1), offset.to(x.dtype).view(1, c, 1, 1)

    def call():
        if (top, left) == (bottom, right):
            y = F.conv2d(x, weight, None, stride, (top, left), groups=c)
        else:
            y = F.conv2d(F.pad(x, (left, right, top, bottom)), weight, None, stride, groups=c)
        return F.silu(torch.addcmul(offset, y, scale))

    return call


def phase_dw_kernel(card):
    import torch

    from tmv_tpu_torch.kernels.dwconv import dw_bn_swish_reference, fused_dw_bn_swish

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [(b, hw, hw, c, k, s) for (hw, c, k, s) in D0_DW_SHAPES for b in (1, 16)]
    cases += DW_EDGE_CASES
    max_err = {}
    for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        worst = 0.0
        for b, h, w, c, k, stride in cases:
            x, taps, scale, offset = dw_inputs(gen, b, h, w, c, k, dtype)
            got = fused_dw_bn_swish(x, taps, scale, offset, stride)
            want = dw_bn_swish_reference(x, taps, scale, offset, stride)
            torch.cuda.synchronize()
            check(got.shape == want.shape and got.dtype == dtype
                  and got.is_contiguous(memory_format=torch.channels_last),
                  f"dw kernel output at {(b, h, w, c, k, stride)} {name}")
            err = float((got.float() - want.float()).abs().max())
            if dtype == torch.float32:
                ok = err <= 1e-5 * float(want.abs().max())
            else:
                ok = within_one_bf16_step(got, want)
            check(ok, f"dw kernel != plain at (B,H,W,C,k,s)={(b, h, w, c, k, stride)} {name}: "
                      f"max |diff| {err:.3g}, max |plain| {float(want.abs().max()):.3g}")
            worst = max(worst, err)
        max_err[name] = worst
        tolerance = "1e-5·max|plain|" + ("" if name == "f32" else " + one bf16 step of plain")
        print(f"phase 7 dw kernel vs plain {name}: {len(cases)} cases (12 D0 @512 shapes at "
              f"B=1 and 16, {len(DW_EDGE_CASES)} edge shapes) within tolerance ({tolerance}); "
              f"max |kernel - plain| = {worst:.3g} on [{card}]", flush=True)

    sums = {}
    for b in (1, 64):
        total = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, device_ms=0.0,
                     device_library_ms=0.0, by={"bytes": 0.0, "operations": 0.0})
        for (hw, c, k, stride), blocks in D0_DW_SHAPES.items():
            x, taps, scale, offset = dw_inputs(gen, b, hw, hw, c, k, torch.bfloat16)

            def kernel():
                fused_dw_bn_swish(x, taps, scale, offset, stride)

            def plain():
                dw_bn_swish_reference(x, taps, scale, offset, stride)

            library = library_dw(x, taps, scale, offset, stride)
            lib_out = library()
            ref = dw_bn_swish_reference(x, taps, scale, offset, stride)
            lib_err = float((lib_out.float() - ref.float()).abs().max())
            check(lib_err <= 0.05 * float(ref.float().abs().max()),
                  f"the library route computes another function at {(hw, c, k, stride)}")
            kernel(), plain()
            kernel_reps, plain_reps = (200, 50) if b == 1 else (20, 5)
            k_ms, p_ms, t = turns(plain, kernel, plain_reps, kernel_reps)
            lib_ms = cuda_ms(library, plain_reps if b > 1 else kernel_reps)
            bound, by = dw_bound_ms(b, hw, c, k, stride, 2)
            on_device = ""
            if b == 1:   # back-to-back calls time the host; the graph times the card
                k_dev, lib_dev = graph_ms(kernel), graph_ms(library)
                total["device_ms"] += blocks * k_dev
                total["device_library_ms"] += blocks * lib_dev
                on_device = (f"; device time (CUDA graph): kernel {k_dev:.4f} ms at "
                             f"{bound / k_dev:.1%} of the bound, library {lib_dev:.4f} ms")
            for key, v in (("ms", k_ms), ("plain_ms", p_ms), ("library_ms", lib_ms),
                           ("bound_ms", bound)):
                total[key] += blocks * v
            total["by"][by] += blocks * bound
            print(f"phase 7 dw time B={b} H=W={hw} C={c} k={k} s={stride} bf16 (x{blocks} per "
                  f"forward) on [{card}]: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, library "
                  f"{lib_ms:.4f} ms, bound {bound:.4f} ms by {by} (kernel at "
                  f"{bound / k_ms:.1%} of the bound; turns plain/kernel/kernel/plain "
                  f"{', '.join(f'{v:.4f}' for v in t)} ms){on_device}", flush=True)
        sums[b] = total
        print(f"phase 7 dw per D0 forward (16 launches) B={b} bf16 on [{card}]: kernel "
              f"{total['ms']:.4f} ms, plain {total['plain_ms']:.4f} ms, library (F.conv2d + "
              f"torch.addcmul + F.silu, F.pad at asymmetric stride 2) {total['library_ms']:.4f} "
              f"ms, bound {total['bound_ms']:.4f} ms"
              + (f"; device time (CUDA graph): kernel {total['device_ms']:.4f} ms, library "
                 f"{total['device_library_ms']:.4f} ms" if b == 1 else ""), flush=True)
    return max(max_err.values()), sums


def seeded_d0(dtype, device, image_size=D0_IMAGE):
    """``--randomInit --seed 0`` D0 (81 classes) with the 80 foreground classes'
    predict bias raised from the focal prior to +1.0."""
    import torch

    from tmv_tpu_torch.models.efficientdet.harness import build_efficientdet
    from tmv_tpu_torch.models.efficientdet.net import init_weights

    model, anchors = build_efficientdet("efficientdet-d0", 81, image_size, dtype=dtype)
    init_weights(model, 0)
    with torch.no_grad():
        model.class_net.net.predict.pointwise.bias.view(9, 81)[:, 1:] = 1.0
    return model.to(device=device, memory_format=torch.channels_last).eval(), anchors


def phase_d0_slice(card):
    import torch

    from tmv_tpu_torch.kernels.nms_sweep import greedy_sweep_reference
    from tmv_tpu_torch.models.efficientdet.harness import (
        build_efficientdet, make_efficientdet_predict_batched,
    )

    torch.backends.cudnn.deterministic = True
    model, anchors = seeded_d0(torch.float32, "cuda")
    weights = os.path.join(WORK, "efficientdet_d0_seed0.pt")
    torch.save({k: v.cpu() for k, v in model.state_dict().items()}, weights)
    images = np.random.default_rng(11).uniform(0, 1, (4, D0_IMAGE, D0_IMAGE, 3)).astype(np.float32)
    predict = make_efficientdet_predict_batched(model, anchors, D0_IMAGE)
    got = predict(None, images)
    with mock.patch("tmv_tpu_torch.ops.nms.greedy_sweep", greedy_sweep_reference):
        want = predict(None, images)
    for g, w, name in zip(got, want, ("boxes", "ids", "scores", "valid")):
        check(np.array_equal(g, w), f"D0 slice {name} differ between kernel and plain sweep")
    boxes, ids, scores, valid = got
    check(boxes.shape == (4, 200, 4) and valid.shape == (4, 200), "D0 predictor output shapes")
    check((valid.sum(1) >= 1).all(), "a D0 image kept no box")
    check(np.isfinite(boxes[valid]).all() and np.isfinite(scores[valid]).all(),
          "non-finite D0 detections")
    check(((ids[valid] >= 0) & (ids[valid] < 80)).all(), "D0 class ids out of range")

    with torch.inference_mode():
        boxes_out, classes_out = model(torch.from_numpy(images).cuda())
        logits = torch.cat([c.float().reshape(4, -1, 81) for c in classes_out], 1)
        above = ((logits.argmax(-1) != 0) & (logits.amax(-1) >= 1e-4)).sum(1).tolist()
        card_heads = [h.float().cpu().numpy() for h in (*boxes_out, *classes_out)]
        box_max = max(float(np.abs(h).max()) for h in card_heads[:5])
    check(min(above) >= 1024, f"the pre-NMS candidates are not filled: {above} above 1e-4")
    print(f"phase 8 D0 slice: EfficientDet-D0 81 classes @{D0_IMAGE} f32 B=4, kernel and plain "
          f"sweep give identical detections, kept per image {valid.sum(1).tolist()}; "
          f"foreground anchors with a raw logit >= 1e-4 per image {above} of "
          f"{logits.shape[1]} (all 1024 pre-NMS candidates eligible); max |box regression| "
          f"{box_max:.3g} on [{card}]", flush=True)

    cpu_model, _ = build_efficientdet("efficientdet-d0", 81, D0_IMAGE, device="cpu")
    cpu_model.load_state_dict(torch.load(weights, weights_only=True), strict=True)
    with torch.inference_mode():
        cpu_heads = [h.numpy() for heads in cpu_model.eval()(torch.from_numpy(images[:4]))
                     for h in heads]
    rel = max(float(np.abs(g - w).max() / np.abs(w).max()) for g, w in zip(card_heads, cpu_heads))
    check(rel <= 1e-4, f"D0 card heads differ from the CPU forward: {rel:.3g} of max|ref|")
    print(f"phase 8 D0 slice: card heads (depthwise kernel, cuDNN) vs CPU forward (plain "
          f"depthwise) of the same state_dict, B=4: max |diff| = {rel:.3g}·max|ref| "
          f"(tolerance 1e-4) on [{card}]", flush=True)
    torch.backends.cudnn.deterministic = False
    return weights


def phase_d0_serving(card, weights):
    from tmv_tpu_torch.cli import serve

    classes_file, _ = write_inputs(COCO_CLASSES)
    args = serve.parse_args(["--family", "efficientdet", "--modelName", "efficientdet-d0",
                             "--modelPath", weights, "--classesFile", classes_file,
                             "--imageSize", str(D0_IMAGE), "--bf16", "--device", "cuda"])
    app, _, model = serve.build_app(args)
    check(all(p.device.type == "cuda" for p in model.parameters()), "D0 is not on cuda")
    latencies, by_read, boxes_seen, launches = drive_server(app, 10, 12)
    n = len(latencies)
    check(launches["dwconv_bn_swish"] == 16 * n,
          f"{launches['dwconv_bn_swish']} depthwise launches for {n} forwards (16 each)")
    check(launches["nms_sweep"] >= n, f"{launches['nms_sweep']} NMS launches for {n} requests")
    p50 = statistics.median(latencies)
    print(f"phase 9 D0 serving: {n} requests -> HTTP 200 with the reference keys, "
          f"{boxes_seen} boxes; dwconv.launches {launches['dwconv_bn_swish']} (16 x {n} "
          f"forwards), nms_sweep.launches {launches['nms_sweep']}; served p50 {p50:.2f} ms "
          f"(read=0 {statistics.median(by_read[0]):.2f} ms, read=1 "
          f"{statistics.median(by_read[1]):.2f} ms) (EfficientDet-D0 bf16 @{D0_IMAGE}, "
          f"on [{card}])", flush=True)
    return launches, p50


def phase_d0_numbers(card, weights, served_p50):
    import torch

    from tmv_tpu_torch.models.efficientdet.harness import (
        build_efficientdet, make_efficientdet_predict, make_efficientdet_predict_batched,
    )

    model, anchors = build_efficientdet("efficientdet-d0", 81, D0_IMAGE, dtype=torch.bfloat16)
    model.load_state_dict(torch.load(weights, weights_only=True), strict=True)
    model = model.to(device="cuda", memory_format=torch.channels_last).eval()
    rng = np.random.default_rng(13)
    one = rng.uniform(0, 1, (1, D0_IMAGE, D0_IMAGE, 3)).astype(np.float32)
    many = rng.uniform(0, 1, (64, D0_IMAGE, D0_IMAGE, 3)).astype(np.float32)
    predict = make_efficientdet_predict(model, anchors, D0_IMAGE)
    batched = make_efficientdet_predict_batched(model, anchors, D0_IMAGE)
    for _ in range(5):
        predict(None, one)
    latencies = []
    for _ in range(50):
        t0 = time.perf_counter()
        predict(None, one)
        latencies.append((time.perf_counter() - t0) * 1000)
    for _ in range(2):
        batched(None, many)
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        batched(None, many)
    ips = 64 * reps / (time.perf_counter() - t0)
    b1 = statistics.median(latencies)
    print(f"phase 10 D0 numbers on [{card}]: EfficientDet-D0 81 classes bf16 @{D0_IMAGE}: "
          f"b1 image->boxes p50 {b1:.2f} ms (host numpy in, host numpy out, 50 runs); "
          f"b64 batched predictor {ips:.1f} images/s; served p50 {served_p50:.2f} ms", flush=True)

    def post(heads):
        boxes_out, classes_out = heads
        decoded = anchors.convert_outputs_boxes([b.float() for b in boxes_out])
        return anchors.convert_outputs_one(decoded, [c.float() for c in classes_out])

    for batch, images, reps in ((1, one, 20), (64, many, 5)):
        predict_b = make_efficientdet_predict_batched(model, anchors, D0_IMAGE)
        stages = stage_times(images, predict_b, model, post, reps)
        print(f"phase 10 stages on [{card}]: EfficientDet-D0 81 classes bf16 @{D0_IMAGE} "
              f"b{batch}: " + ", ".join(f"{k} {v:.2f} ms" for k, v in stages.items()),
              flush=True)
    return b1, ips


# ---------------------------------------------------------------- training

def write_train_set(root):
    """64 synthetic 416 x 416 JPEGs by ``tools/e2e_converged_map.py::make_dataset``
    (seed 7; its 4 colour classes), a classes file of 80 names (the 4 colours
    and 76 COCO names), the COCO anchors and a val label file of the first 16."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from e2e_converged_map import CLASS_COLORS, make_dataset

    from tmv_tpu_torch.models.yolo_v4 import COCO_ANCHORS

    make_dataset(root, n=TRAIN_SET, hw=TRAIN_IMAGE)
    names = list(CLASS_COLORS) + [c for c in COCO_CLASSES if c not in CLASS_COLORS]
    with open(os.path.join(root, "classes.txt"), "w") as f:
        f.write("\n".join(names[:80]) + "\n")
    with open(os.path.join(root, "anchors.txt"), "w") as f:
        f.write(",".join(str(int(v)) for v in COCO_ANCHORS[::-1].reshape(-1)))
    with open(os.path.join(root, "labels.txt")) as f:
        lines = f.readlines()
    with open(os.path.join(root, "val_labels.txt"), "w") as f:
        f.writelines(lines[:VAL_SET])
    return {k: os.path.join(root, v) for k, v in (
        ("images", "imgs"), ("labels", "labels.txt"), ("val", "val_labels.txt"),
        ("classes", "classes.txt"), ("anchors", "anchors.txt"))}


def train_setup(files, dtype, device, seed=0, version="v4"):
    """The CLI's model, optimizer, train state, loss and step at 416 (v4's
    loss with CIoU, v3's with IoU)."""
    import torch

    from tmv_tpu_torch.core.train_state import TrainState, make_train_step
    from tmv_tpu_torch.data.loaders import load_anchors
    from tmv_tpu_torch.models.detector_harness import build_yolo_model, make_yolo_loss_fn
    from tmv_tpu_torch.models.layers.common import init_weights

    anchors = load_anchors(files["anchors"])
    model, _ = build_yolo_model(version, 80, dtype=dtype, device=device,
                                param_dtype=torch.float32)
    init_weights(model, seed)
    model = model.to(memory_format=torch.channels_last)
    state = TrainState.create(model, torch.optim.Adam(model.parameters(), lr=5e-4))
    loss_fn = make_yolo_loss_fn((TRAIN_IMAGE, TRAIN_IMAGE), anchors,
                                iou_type="ciou" if version == "v4" else "iou")
    return state, loss_fn, make_train_step(loss_fn, shadow_loss=True), anchors


def step_kernel_ms(fn, reps):
    """Device milliseconds of the kernels of one ``fn`` call: the sum of every
    kernel's time that ``torch.profiler`` traces over ``reps`` calls, per call
    (0 where the profiler traces no kernel)."""
    import torch

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
                   for e in prof.key_averages())
    return total_us / 1e3 / reps


def grads_of(model):
    return {n: p.grad.detach().cpu().double() for n, p in model.named_parameters()}


def phase_train(card, files):
    import torch

    from tmv_tpu_torch.cli import train_yolo
    from tmv_tpu_torch.data.yolo_pipeline import YoloDataPipeline
    from tmv_tpu_torch.kernels import nms_sweep
    from tmv_tpu_torch.ops.yolo import yolo_loss

    ckpt = os.path.join(WORK, "yolov4_train")
    argv = ["--version", "v4", "--trainData", files["labels"], "--trainImagePath",
            files["images"], "--valData", files["val"], "--valImagePath", files["images"],
            "--classesFile", files["classes"], "--anchorsFile", files["anchors"],
            "--imageSize", str(TRAIN_IMAGE), "--batchSize", str(TRAIN_BATCH), "--bf16",
            "--stepsPerEpoch", str(TRAIN_STEPS_PER_EPOCH), "--epochs", "2", "--lr", "5e-4",
            "--modelPath", ckpt, "--device", "cuda"]
    torch.cuda.reset_peak_memory_stats()
    nms_sweep.launches = 0
    t0 = time.perf_counter()
    out = train_yolo.main(argv)
    wall = time.perf_counter() - t0
    val_launches = nms_sweep.launches
    cli_peak = torch.cuda.max_memory_allocated() / 2**30
    with open(os.path.join(ckpt, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    losses = [r["raw_loss"] for r in records]
    steps = 2 * TRAIN_STEPS_PER_EPOCH
    check(out["step"] == steps and len(records) == steps, f"the CLI took {out['step']} steps")
    check(all(np.isfinite(r["loss"]) and np.isfinite(r["raw_loss"]) for r in records),
          "a non-finite training loss")
    check(len(out["val_mAP"]) == 2 and all(np.isfinite(out["val_mAP"])), "val mAP missing")
    check(val_launches >= 2 * VAL_SET, f"{val_launches} NMS launches for {2 * VAL_SET} val images")
    host_step = statistics.median(r["step_time_s"] for r in records[max(1, steps // 4):]) * 1e3
    print(f"phase 11 train CLI: YOLOv4 80 classes @{TRAIN_IMAGE} b{TRAIN_BATCH} bf16 "
          f"(float32 master weights), {steps} steps in {wall:.1f} s with two val passes of "
          f"{VAL_SET} images and three checkpoints; raw loss first {losses[0]:.2f}, last "
          f"{losses[-1]:.2f}; val mAP per epoch {[round(m, 4) for m in out['val_mAP']]}; "
          f"host step time p50 {host_step:.2f} ms; nms_sweep.launches in the val passes "
          f"{val_launches}; peak memory {cli_peak:.2f} GiB on [{card}]", flush=True)

    state, _, step, anchors = train_setup(files, torch.bfloat16, "cuda")
    pipeline = YoloDataPipeline(files["images"], files["labels"], files["classes"],
                                TRAIN_BATCH, anchors, image_wh=(TRAIN_IMAGE, TRAIN_IMAGE),
                                device="cuda")
    batches = iter(pipeline)
    batch = next(batches)
    batches.close()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):
        step(state, batch)
    reps = 10
    step_ms = cuda_ms(lambda: step(state, batch), reps)
    peak = torch.cuda.max_memory_allocated() / 2**30
    parts = {"forward": [], "loss": [], "backward": [], "optimizer": []}
    model = state.model
    for _ in range(5):
        events = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        state.optimizer.zero_grad(set_to_none=True)
        events[0].record()
        heads = model(batch["image"])
        events[1].record()
        loss = yolo_loss(batch["targets"], heads, (TRAIN_IMAGE, TRAIN_IMAGE), anchors,
                         iou_type="ciou")
        events[2].record()
        loss.backward()
        events[3].record()
        state.optimizer.step()
        events[4].record()
        torch.cuda.synchronize()
        for k, (a, b) in zip(parts, zip(events, events[1:])):
            parts[k].append(a.elapsed_time(b))
    parts = {k: statistics.median(v) for k, v in parts.items()}
    kernel_ms = step_kernel_ms(lambda: step(state, batch), 3)
    alone_ms = host_ms(lambda: step(state, batch), 5)
    labels = [next(iter(pipeline.sampler)) for _ in range(TRAIN_BATCH)]
    with ThreadPoolExecutor(TRAIN_BATCH) as pool:
        stage_host = host_ms(lambda: pipeline.stage_batch(labels, pool), 5)
        staged = pipeline.stage_batch(labels, pool)
    stage_device = cuda_ms(lambda: pipeline.device_batch(staged), 5)
    print(f"phase 11 train step on [{card}]: YOLOv4 80 classes @{TRAIN_IMAGE} b{TRAIN_BATCH} "
          f"bf16: {step_ms:.2f} ms per step by CUDA events over {reps} steps after 3 of "
          f"warm-up = {TRAIN_BATCH * 1e3 / step_ms:.1f} images/s; parts (CUDA events, "
          f"median of 5): " + ", ".join(f"{k} {v:.2f} ms" for k, v in parts.items())
          + f"; one step between synchronisations (host clock, median of 5) {alone_ms:.2f} ms"
          + f"; kernels' device time per step (torch.profiler, 3 steps) "
          + (f"{kernel_ms:.2f} ms, busy share {kernel_ms / step_ms:.3f}" if kernel_ms else
             "not measured (the profiler traced no kernel)")
          + f"; data pipeline per batch of {TRAIN_BATCH}: host decode + resize "
          f"{stage_host:.2f} ms on {TRAIN_BATCH} threads, device H2D + augmentation + "
          f"targets {stage_device:.2f} ms; peak memory {peak:.2f} GiB", flush=True)

    state, _, step, _ = train_setup(files, torch.bfloat16, "cuda", seed=1)
    overfit = [float(step(state, batch)["raw_loss"]) for _ in range(OVERFIT_STEPS)]
    check(all(np.isfinite(overfit)), "non-finite loss in the overfit")
    check(overfit[-1] <= overfit[0] / 2,
          f"overfitting one batch: raw loss {overfit[0]:.2f} -> {overfit[-1]:.2f}")
    print(f"phase 11 overfit of one fixed batch, {OVERFIT_STEPS} steps bf16 lr 5e-4: raw loss "
          f"{overfit[0]:.2f} -> {overfit[-1]:.2f} ({overfit[0] / overfit[-1]:.1f}x lower; "
          f"required >= 2x) on [{card}]", flush=True)
    del state, batch
    f32 = phase_train_f32(card, files, anchors)
    resume = phase_resume(card, files, ckpt, steps)
    return {"ckpt": ckpt, "val_launches": val_launches, "step_ms": step_ms, "parts": parts,
            "kernel_ms": kernel_ms, "alone_ms": alone_ms, "peak": peak, "f32": f32,
            "resume": resume}


def rel_l2(got, want):
    """(relative L2 error over all tensors, worst tensor's) of two gradient dicts;
    the worst is taken over the tensors whose norm is above 1e-12 of the largest
    (a zero gradient, as D0's box levels without positives have, has none)."""
    num = sum(float((got[k].double() - want[k].double()).norm() ** 2) for k in want)
    den = sum(float(want[k].double().norm() ** 2) for k in want)
    norms = {k: float(want[k].double().norm()) for k in want}
    floor = 1e-12 * max(norms.values())
    worst = max(float((got[k].double() - want[k].double()).norm()) / norms[k]
                for k in want if norms[k] > floor)
    return (num / den) ** 0.5, worst


def phase_train_f32(card, files, anchors, version="v4", phase=11):
    """One float32 step (TF32 off) on the card and on the CPU from one state_dict
    and one batch at 416, B = 2, beside the same step in float64 on the CPU.
    Train-mode BatchNorm at random init amplifies rounding through the ~75-107
    layers, so float32 gradients (the CPU's too) sit far from the float64 ones;
    the card must be as close to float64 as the CPU's float32 is (within 2x,
    plus 1e-4) and agree with the CPU on the loss within 1e-3."""
    import torch

    from tmv_tpu_torch.data.yolo_pipeline import YoloDataPipeline
    from tmv_tpu_torch.models.detector_harness import check_device

    check(not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32,
          "TF32 must stay off for the float32 comparison")
    pipeline = YoloDataPipeline(files["images"], files["labels"], files["classes"], 2, anchors,
                                image_wh=(TRAIN_IMAGE, TRAIN_IMAGE), prefetch=0, device="cpu")
    batches = iter(pipeline)
    batch = next(batches)
    batches.close()
    results = {}
    for name, device, dtype in (("card", "cuda", torch.float32), ("cpu", "cpu", torch.float32),
                                ("cpu f64", "cpu", torch.float64)):
        state, loss_fn, _, _ = train_setup(files, torch.float32, device, seed=2, version=version)
        model = state.model.to(dtype).train()
        model.dtype = dtype
        on = {"image": batch["image"].to(check_device(device), dtype),
              "targets": tuple(t.to(check_device(device), dtype) for t in batch["targets"])}
        loss, _ = loss_fn(model, on)
        loss.backward()
        results[name] = (loss.item(), grads_of(model))
        del state, model
    (card_loss, card_g), (cpu_loss, cpu_g), (ref_loss, ref_g) = (
        results[k] for k in ("card", "cpu", "cpu f64"))
    loss_rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    card_err, cpu_err = rel_l2(card_g, ref_g), rel_l2(cpu_g, ref_g)
    card_cpu = rel_l2(card_g, cpu_g)
    check(loss_rel <= 1e-3, f"f32 loss card {card_loss} vs CPU {cpu_loss}")
    check(card_err[0] <= 2 * cpu_err[0] + 1e-4 and card_err[1] <= 2 * cpu_err[1] + 1e-4,
          f"f32 gradients: card vs float64 {card_err}, CPU vs float64 {cpu_err}")
    print(f"phase {phase} f32 step card vs CPU (TF32 off, {YOLO_NAMES[version]} 80 classes "
          f"@{TRAIN_IMAGE} B=2, one "
          f"state_dict and batch, train mode): loss card {card_loss:.4f}, CPU {cpu_loss:.4f} "
          f"(relative {loss_rel:.3g}, tolerance 1e-3), CPU float64 {ref_loss:.4f}; gradients' "
          f"relative L2 error (overall, worst of {len(ref_g)} tensors) against the CPU float64 "
          f"step: card {card_err[0]:.3g}, {card_err[1]:.3g}; CPU float32 {cpu_err[0]:.3g}, "
          f"{cpu_err[1]:.3g} (tolerance: the card within 2x the CPU's + 1e-4); card vs CPU "
          f"float32 {card_cpu[0]:.3g}, {card_cpu[1]:.3g} on [{card}]", flush=True)
    return {"loss_rel": loss_rel, "card_err": card_err, "cpu_err": cpu_err}


def phase_resume(card, files, ckpt, steps):
    """Restore the CLI's last checkpoint into a fresh state, check the step and
    the Adam state, take one step and check that both continue."""
    import torch

    from tmv_tpu_torch.core.checkpoint import CheckpointManager
    from tmv_tpu_torch.data.yolo_pipeline import YoloDataPipeline

    state, _, step, anchors = train_setup(files, torch.bfloat16, "cuda", seed=3)
    mgr = CheckpointManager(ckpt)
    saved = torch.load(mgr.path(mgr.latest_step()), map_location="cpu", weights_only=True)
    mgr.restore(state)
    check(state.step == steps == saved["step"], f"restored step {state.step}, expected {steps}")
    adam = state.optimizer.state_dict()["state"]
    check(all(int(v["step"]) == steps for v in adam.values()), "restored Adam step count")
    first = next(iter(saved["optimizer"]["state"]))
    check(torch.equal(adam[first]["exp_avg"].cpu(), saved["optimizer"]["state"][first]["exp_avg"]),
          "restored Adam moments")
    pipeline = YoloDataPipeline(files["images"], files["labels"], files["classes"], TRAIN_BATCH,
                                anchors, image_wh=(TRAIN_IMAGE, TRAIN_IMAGE), prefetch=0,
                                device="cuda")
    batches = iter(pipeline)
    metrics = step(state, next(batches))
    batches.close()
    adam = state.optimizer.state_dict()["state"]
    check(state.step == steps + 1 and all(int(v["step"]) == steps + 1 for v in adam.values()),
          "the step count did not continue after the resume")
    check(np.isfinite(float(metrics["loss"])), "non-finite loss after the resume")
    saved_avg = saved["optimizer"]["state"][first]["exp_avg"]
    moved = not torch.equal(adam[first]["exp_avg"].cpu(), saved_avg)
    check(moved, "the Adam moments did not move after the resume")
    mgr.close()
    print(f"phase 11 resume: checkpoint step {saved['step']} restored (Adam step count "
          f"{steps} on all {len(adam)} tensors), one more step -> step {state.step}, Adam step "
          f"{steps + 1}, loss {float(metrics['loss']):.2f} on [{card}]", flush=True)
    return state.step


def write_own_labels(files, records, name="own_labels.txt"):
    """A label file of the model's own detections: for each image its 4
    best-scored kept boxes that lie inside the image and span more than 2 px,
    each corner moved by up to 2 px, and one box the model did not find, so
    that an eval against it scores strictly between 0 and 1. The eval CLI's
    records come in its sampler's order (seed 0), which maps them to the
    images. Returns the file's path (``name`` beside the set's labels) and the number
    of the model's boxes in it."""
    from tmv_tpu_torch.data.loaders import load_classes, load_labels
    from tmv_tpu_torch.data.samplers import ClassBalancedSampler

    names, _ = load_classes(files["classes"])
    labels, _ = load_labels(files["labels"], files["images"], names)
    order = iter(ClassBalancedSampler(labels, label_mean=False, seed=0))
    rng = np.random.default_rng(12)
    entries, count = {}, 0
    for i, record in enumerate(records):
        inside = [row for row in record["prediction"]
                  if 0 <= row[0] and 0 <= row[1] and row[2] <= 1 and row[3] <= 1
                  and min(row[2] - row[0], row[3] - row[1]) * TRAIN_IMAGE > 2]
        own = []
        for *box, cls, _score in sorted(inside, key=lambda row: -row[5])[:4]:
            x1, y1, x2, y2 = np.clip(np.array(box) * TRAIN_IMAGE + rng.uniform(-2, 2, 4), 0,
                                     TRAIN_IMAGE)
            own.append(f"{names[int(cls)]},{x1:.1f},{y1:.1f},{x2:.1f},{y2:.1f}")
        count += len(own)
        own.append(f"{names[i % 4]},3,3,40,36")
        entries[next(order)["image_path"]] = own
    path = os.path.join(os.path.dirname(files["labels"]), name)
    with open(path, "w") as f:
        for label in labels:
            f.write(f"{os.path.basename(label['image_path'])}|"
                    f"{'|'.join(entries[label['image_path']])}|\n")
    return path, count


def scored_records(records_fn, trained, seeded, modes):
    """The eval CLI's records of the trained and the seeded model (``records_fn`` of
    each argv: one prediction pass each), and their mAPs in every mode scored from
    that one pass → (trained's mAPs, both models' records, seeded's mAPs). The
    modes differ only in scoring, so a re-run that checks kept rows predicts once."""
    from tmv_tpu_torch.cli import eval_map

    out, records = [], []
    for argv in (trained, seeded):
        args = eval_map.parse_args(argv)
        data, classes_num = records_fn(args)
        records += data
        out.append({mode: {"mAP": eval_map.score_dataset(data, classes_num, mode, args.variant,
                                                           args.thresh), "images": len(data)}
                    for mode in modes})
    return out[0], records, out[1]


def phase_eval(card, files, ckpt):
    """The eval CLI through the NMS kernel, then again with the plain sweep: on
    the trained checkpoint against the set's labels, and on a ``.pt`` of the
    serving phases' seeded weights (sane boxes at every cell) against labels
    made from its own detections, which must score strictly between 0 and 1."""
    import torch

    from tmv_tpu_torch.cli import eval_map
    from tmv_tpu_torch.kernels import nms_sweep
    from tmv_tpu_torch.kernels.nms_sweep import greedy_sweep_reference

    seeded_pt = os.path.join(WORK, "seeded_yolov4.pt")
    torch.save(seeded_model(torch.float32, "cuda")[0].state_dict(), seeded_pt)
    common = ["--family", "yolo", "--version", "v4", "--imagePath", files["images"],
              "--classesFile", files["classes"], "--anchorsFile", files["anchors"],
              "--imageSize", str(TRAIN_IMAGE), "--confidenceThresh", "0.2",
              "--scoresThresh", "0.05", "--batchSize", "8", "--bf16", "--device", "cuda"]
    trained = common + ["--modelPath", ckpt, "--labelFile", files["labels"]]
    seeded = common + ["--modelPath", seeded_pt]
    modes = ("batch", "global")

    def evaluate():
        """Both modes and the records of each model; the seeded model's own
        labels are written from its records."""
        maps = {mode: eval_map.main(trained + ["--mode", mode]) for mode in modes}
        records, _ = eval_map.predict_records(eval_map.parse_args(trained))
        seeded_records, _ = eval_map.predict_records(
            eval_map.parse_args(seeded + ["--labelFile", files["labels"]]))
        own_labels = write_own_labels(files, seeded_records)
        own = {mode: eval_map.main(seeded + ["--mode", mode, "--labelFile", own_labels[0]])
               for mode in modes}
        return maps, records + seeded_records, own, own_labels

    nms_sweep.launches = 0
    maps, records, own, own_labels = evaluate()
    launches = nms_sweep.launches
    with mock.patch("tmv_tpu_torch.ops.nms.greedy_sweep", greedy_sweep_reference):
        plain, plain_records, plain_own = scored_records(
            eval_map.predict_records, trained, seeded + ["--labelFile", own_labels[0]], modes)
    batches = 6 * TRAIN_SET // 8
    check(launches >= batches, f"{launches} NMS launches for {batches} eval batches")
    check(nms_sweep.launches == launches, "the plain sweep launched the kernel")
    for name, got, want in (("trained", maps, plain), ("seeded", own, plain_own)):
        for mode in modes:
            check(got[mode]["mAP"] == want[mode]["mAP"] and got[mode]["images"] == TRAIN_SET,
                  f"eval {mode} of the {name} model: kernel mAP {got[mode]['mAP']} vs plain "
                  f"{want[mode]['mAP']}")
    check(own_labels[1] > 0 and all(0 < own[mode]["mAP"] < 1 for mode in modes),
          f"eval on the seeded model's own labels ({own_labels[1]} boxes): mAP "
          f"{[own[m]['mAP'] for m in modes]} not in (0, 1)")
    kept = [sum(len(r["prediction"]) for r in part)
            for part in (records[:TRAIN_SET], records[TRAIN_SET:])]
    check(min(kept) > 0, f"boxes kept by the trained and the seeded model: {kept}")
    check(all(a["prediction"] == b["prediction"] for a, b in zip(records, plain_records)),
          "kept sets differ between the kernel and the plain sweep")
    print(f"phase 12 eval: tmv_tpu_torch.cli.eval_map, {TRAIN_SET} images @{TRAIN_IMAGE} bf16 "
          f"b8: the trained checkpoint on the set's labels mAP batch {maps['batch']['mAP']:.4f}, "
          f"global {maps['global']['mAP']:.4f}; the seeded weights on their own labels "
          f"({own_labels[1]} of their kept boxes moved by up to 2 px, plus one missed box per "
          f"image) batch {own['batch']['mAP']:.4f}, global {own['global']['mAP']:.4f}; each "
          f"equal with the plain sweep; kept sets identical ({kept[0]} and {kept[1]} boxes "
          f"kept); nms_sweep.launches {launches} on [{card}]", flush=True)
    return launches

# ---------------------------------------------------------------- D0 training

def d0_train_setup(files, dtype, device, seed=0, survival_prob=None, lr=None):
    """The D0 trainer's model (81 classes @512, float32 master weights), SGD on
    the CLI's cosine schedule at b16 (or a constant ``lr``), train state with
    the weight EMA, generator, loss and step."""
    import torch

    from tmv_tpu_torch.core.schedules import cosine_lr_schedule, scaled_lr
    from tmv_tpu_torch.core.train_state import TrainState, make_train_step
    from tmv_tpu_torch.models.efficientdet.harness import build_efficientdet
    from tmv_tpu_torch.models.efficientdet.net import init_weights, make_efficientdet_loss_fn

    model, anchors = build_efficientdet("efficientdet-d0", 81, D0_IMAGE, dtype=dtype,
                                        device=device, param_dtype=torch.float32)
    if survival_prob is not None:
        for net in (model.class_net.net, model.box_net.net):
            net.survival_prob = survival_prob
    init_weights(model, seed)
    model = model.to(memory_format=torch.channels_last)
    schedule = (cosine_lr_schedule(scaled_lr(0.08, D0_TRAIN_BATCH), 0.008,
                                   TRAIN_STEPS_PER_EPOCH, 2 * TRAIN_STEPS_PER_EPOCH)
                if lr is None else (lambda step: lr))
    optimizer = torch.optim.SGD(model.parameters(), lr=float(schedule(0)), momentum=0.9)
    state = TrainState.create(model, optimizer, ema_decay=0.9998)
    generator = torch.Generator(device).manual_seed(seed)
    loss_fn = make_efficientdet_loss_fn(generator=generator)
    step = make_train_step(loss_fn, clip_global_norm=10.0, ema_decay=0.9998,
                           lr_schedule=schedule)
    return state, loss_fn, step, anchors, generator


def d0_batches(files, anchors, batch_size, device, device_aug=True, prefetch=2):
    from tmv_tpu_torch.data.efficientdet_pipeline import EfficientDetPipeline

    return EfficientDetPipeline(files["images"], files["labels"], files["classes"], batch_size,
                                anchors, 81, image_size=D0_IMAGE, device_aug=device_aug,
                                prefetch=prefetch, device=device)


def phase_d0_train(card, files):
    """The D0 trainer CLI, then its step's time and parts, an overfit, the
    float32 step against float64 and a resume."""
    import torch

    from tmv_tpu_torch.cli import train_efficientdet
    from tmv_tpu_torch.kernels import dwconv, nms_sweep
    from tmv_tpu_torch.models.efficientdet.net import efficientdet_loss

    ckpt = os.path.join(WORK, "d0_train")
    argv = ["--modelName", "efficientdet-d0", "--trainData", files["labels"],
            "--trainImagePath", files["images"], "--classesFile", files["classes"],
            "--imageSize", str(D0_IMAGE), "--batchSize", str(D0_TRAIN_BATCH), "--bf16",
            "--deviceAug", "--stepsPerEpoch", str(TRAIN_STEPS_PER_EPOCH), "--epochs", "2",
            "--modelPath", ckpt, "--device", "cuda"]
    torch.cuda.reset_peak_memory_stats()
    dwconv.launches = nms_sweep.launches = 0
    t0 = time.perf_counter()
    out = train_efficientdet.main(argv)
    wall = time.perf_counter() - t0
    check(dwconv.launches == 0 and nms_sweep.launches == 0,
          "the D0 train step launched a hand-written kernel")
    cli_peak = torch.cuda.max_memory_allocated() / 2**30
    with open(os.path.join(ckpt, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    steps = 2 * TRAIN_STEPS_PER_EPOCH
    check(out["step"] == steps and len(records) == steps, f"the D0 CLI took {out['step']} steps")
    check(all(np.isfinite(r["loss"]) and np.isfinite(r["gnorm"]) for r in records),
          "a non-finite D0 training loss")
    host_step = statistics.median(r["step_time_s"] for r in records[max(1, steps // 4):]) * 1e3
    print(f"phase 13 D0 train CLI: EfficientDet-D0 81 classes @{D0_IMAGE} b{D0_TRAIN_BATCH} bf16 "
          f"(float32 master weights) --deviceAug, {steps} steps in {wall:.1f} s with three "
          f"checkpoints; loss first {records[0]['loss']:.3f}, last {records[-1]['loss']:.3f}; "
          f"host step time p50 {host_step:.2f} ms; dwconv and nms launches in training 0; "
          f"peak memory {cli_peak:.2f} GiB on [{card}]", flush=True)

    state, _, step, anchors, generator = d0_train_setup(files, torch.bfloat16, "cuda")
    pipeline = d0_batches(files, anchors, D0_TRAIN_BATCH, "cuda", prefetch=0)
    batches = iter(pipeline)
    batch = next(batches)
    batches.close()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):
        step(state, batch)
    reps = 10
    step_ms = cuda_ms(lambda: step(state, batch), reps)
    peak = torch.cuda.max_memory_allocated() / 2**30
    parts = {"forward": [], "loss": [], "backward": [], "SGD (clip + update)": [], "EMA": []}
    model, optimizer = state.model, state.optimizer
    ema_names = list(state.ema_params)
    live = dict(model.named_parameters())
    for _ in range(5):
        events = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        optimizer.zero_grad(set_to_none=True)
        events[0].record()
        outputs = model(batch["image"], generator=generator)
        events[1].record()
        loss = efficientdet_loss(model, outputs, batch)
        events[2].record()
        loss.backward()
        events[3].record()
        grads = [p.grad for p in model.parameters()]
        gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        torch._foreach_mul_(grads, torch.clamp(10.0 / (gnorm + 1e-12), max=1.0))
        optimizer.step()
        events[4].record()
        ema = [state.ema_params[n] for n in ema_names]
        torch._foreach_mul_(ema, 0.9998)
        torch._foreach_add_(ema, [live[n].detach() for n in ema_names], alpha=1.0 - 0.9998)
        events[5].record()
        torch.cuda.synchronize()
        for k, (a, b) in zip(parts, zip(events, events[1:])):
            parts[k].append(a.elapsed_time(b))
    parts = {k: statistics.median(v) for k, v in parts.items()}
    kernel_ms = step_kernel_ms(lambda: step(state, batch), 3)
    alone_ms = host_ms(lambda: step(state, batch), 5)
    labels = [next(iter(pipeline.sampler)) for _ in range(D0_TRAIN_BATCH)]
    with ThreadPoolExecutor(8) as pool:
        stage_host = host_ms(lambda: pipeline.stage_batch(labels, pool), 5)
        staged = pipeline.stage_batch(labels, pool)
    stage_device = cuda_ms(lambda: pipeline.device_batch(staged), 5)
    print(f"phase 13 D0 train step on [{card}]: EfficientDet-D0 81 classes @{D0_IMAGE} "
          f"b{D0_TRAIN_BATCH} bf16: {step_ms:.2f} ms per step by CUDA events over {reps} steps "
          f"after 3 of warm-up = {D0_TRAIN_BATCH * 1e3 / step_ms:.1f} images/s; parts (CUDA "
          f"events, median of 5): " + ", ".join(f"{k} {v:.2f} ms" for k, v in parts.items())
          + f"; one step between synchronisations (host clock, median of 5) {alone_ms:.2f} ms"
          + "; kernels' device time per step (torch.profiler, 3 steps) "
          + (f"{kernel_ms:.2f} ms, busy share {kernel_ms / step_ms:.3f}" if kernel_ms else
             "not measured (the profiler traced no kernel)")
          + f"; data pipeline (--deviceAug) per batch of {D0_TRAIN_BATCH}: host decode + "
          f"letterbox {stage_host:.2f} ms on 8 threads, device H2D + augmentation + targets "
          f"{stage_device:.2f} ms; peak memory {peak:.2f} GiB", flush=True)
    del state, model, optimizer, live, outputs, loss, grads

    state, _, step, _, _ = d0_train_setup(files, torch.bfloat16, "cuda", seed=1,
                                          lr=D0_OVERFIT_LR)
    overfit = [float(step(state, batch)["raw_loss"]) for _ in range(OVERFIT_STEPS)]
    check(all(np.isfinite(overfit)), "non-finite loss in the D0 overfit")
    tail = statistics.mean(overfit[-3:])
    check(tail <= overfit[0] / 2, f"overfitting one D0 batch: raw loss {overfit[0]:.2f} -> "
          f"{tail:.2f} (mean of the last 3)")
    print(f"phase 13 D0 overfit of one fixed batch, {OVERFIT_STEPS} steps bf16 SGD lr "
          f"{D0_OVERFIT_LR} (momentum 0.9, clip 10): raw loss {overfit[0]:.2f} -> {tail:.2f} "
          f"(mean of the last 3; {overfit[0] / tail:.1f}x lower, required >= 2x) on [{card}]",
          flush=True)
    del state, batch
    f32 = phase_d0_train_f32(card, files)
    resume = phase_d0_resume(card, files, ckpt, steps)
    return {"ckpt": ckpt, "step_ms": step_ms, "parts": parts, "kernel_ms": kernel_ms,
            "alone_ms": alone_ms, "peak": peak, "f32": f32, "resume": resume}


def phase_d0_train_f32(card, files):
    """One float32 D0 step (TF32 off) on the card and on the CPU from one
    state_dict and one batch at 512, B = 2, ``survival_prob`` 1 (no dropout
    draws to differ), beside the same step in float64 on the CPU: phase 11's
    rule, the card as close to float64 as the CPU's float32 (within 2x, plus
    1e-4), the losses within 1e-3."""
    import torch

    from tmv_tpu_torch.models.detector_harness import check_device

    check(not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32,
          "TF32 must stay off for the float32 comparison")
    state, _, _, anchors, _ = d0_train_setup(files, torch.float32, "cpu", seed=2)
    batches = iter(d0_batches(files, anchors, 2, "cpu", device_aug=False, prefetch=0))
    batch = next(batches)
    batches.close()
    results = {}
    for name, device, dtype in (("card", "cuda", torch.float32), ("cpu", "cpu", torch.float32),
                                ("cpu f64", "cpu", torch.float64)):
        state, loss_fn, _, _, _ = d0_train_setup(files, torch.float32, device, seed=2,
                                                 survival_prob=1.0)
        model = state.model.to(dtype).train()
        model.dtype = dtype
        dev = check_device(device)
        on = {"image": batch["image"].to(dev, dtype),
              "boxes": tuple(t.to(dev, dtype) for t in batch["boxes"]),
              "classes": tuple(t.to(dev, dtype) for t in batch["classes"]),
              "masks": tuple(t.to(dev) for t in batch["masks"])}
        loss, _ = loss_fn(model, on)
        loss.backward()
        results[name] = (loss.item(), grads_of(model))
        del state, model
    (card_loss, card_g), (cpu_loss, cpu_g), (ref_loss, ref_g) = (
        results[k] for k in ("card", "cpu", "cpu f64"))
    loss_rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    card_err, cpu_err = rel_l2(card_g, ref_g), rel_l2(cpu_g, ref_g)
    check(loss_rel <= 1e-3, f"D0 f32 loss card {card_loss} vs CPU {cpu_loss}")
    check(card_err[0] <= 2 * cpu_err[0] + 1e-4 and card_err[1] <= 2 * cpu_err[1] + 1e-4,
          f"D0 f32 gradients: card vs float64 {card_err}, CPU vs float64 {cpu_err}")
    print(f"phase 13 D0 f32 step card vs CPU (TF32 off, EfficientDet-D0 81 classes @{D0_IMAGE} "
          f"B=2, one state_dict and batch, train mode): loss card {card_loss:.6f}, CPU "
          f"{cpu_loss:.6f} (relative {loss_rel:.3g}, tolerance 1e-3), CPU float64 "
          f"{ref_loss:.6f}; gradients' relative L2 error (overall, worst of {len(ref_g)} "
          f"tensors) against the CPU float64 step: card {card_err[0]:.3g}, {card_err[1]:.3g}; "
          f"CPU float32 {cpu_err[0]:.3g}, {cpu_err[1]:.3g} (tolerance: the card within 2x the "
          f"CPU's + 1e-4) on [{card}]", flush=True)
    return {"loss_rel": loss_rel, "card_err": card_err, "cpu_err": cpu_err}


def phase_d0_resume(card, files, ckpt, steps):
    """Restore the D0 CLI's last checkpoint into a fresh state: the step, the
    SGD momentum and the EMA come back; one more step moves them on."""
    import torch

    from tmv_tpu_torch.core.checkpoint import CheckpointManager

    state, _, step, anchors, _ = d0_train_setup(files, torch.bfloat16, "cuda", seed=3)
    mgr = CheckpointManager(ckpt)
    saved = torch.load(mgr.path(mgr.latest_step()), map_location="cpu", weights_only=True)
    mgr.restore(state)
    mgr.close()
    check(state.step == steps == saved["step"], f"restored D0 step {state.step}, expected {steps}")
    sgd = state.optimizer.state_dict()["state"]
    first = next(iter(saved["optimizer"]["state"]))
    saved_buf = saved["optimizer"]["state"][first]["momentum_buffer"]
    check(torch.equal(sgd[first]["momentum_buffer"].cpu(), saved_buf), "restored SGD momentum")
    name = next(iter(saved["ema_params"]))
    check(torch.equal(state.ema_params[name].cpu(), saved["ema_params"][name]), "restored EMA")
    batches = iter(d0_batches(files, anchors, D0_TRAIN_BATCH, "cuda", prefetch=0))
    metrics = step(state, next(batches))
    batches.close()
    sgd = state.optimizer.state_dict()["state"]
    check(state.step == steps + 1, "the D0 step count did not continue after the resume")
    check(np.isfinite(float(metrics["loss"])), "non-finite D0 loss after the resume")
    check(not torch.equal(sgd[first]["momentum_buffer"].cpu(), saved_buf),
          "the SGD momentum did not move after the resume")
    print(f"phase 13 D0 resume: checkpoint step {saved['step']} restored (SGD momentum of "
          f"{len(sgd)} tensors, the EMA of {len(saved['ema_params'])}), one more step -> step "
          f"{state.step}, loss {float(metrics['loss']):.3f}, lr "
          f"{state.optimizer.param_groups[0]['lr']:.5f} on [{card}]", flush=True)
    return state.step


def write_d0_own_labels(files, records):
    """A label file of the seeded D0's own detections (``records`` of the eval
    CLI, yxyx pixels at 512, 1-based ids): per image its 4 best kept boxes that
    lie inside the image and span more than 2 px, mapped back to the 416 px
    images, each corner moved by up to 2 px, plus one box the model did not
    find. Returns the file's path and the number of the model's boxes in it."""
    from tmv_tpu_torch.data.loaders import load_classes, load_labels
    from tmv_tpu_torch.data.samplers import ClassBalancedSampler

    names, _ = load_classes(files["classes"])
    labels, _ = load_labels(files["labels"], files["images"], names)
    order = iter(ClassBalancedSampler(labels, label_mean=False, seed=0))
    rng = np.random.default_rng(14)
    scale = TRAIN_IMAGE / D0_IMAGE
    entries, count = {}, 0
    for i, record in enumerate(records):
        inside = [row for row in record["prediction"]
                  if 0 <= row[0] and 0 <= row[1] and row[2] <= D0_IMAGE and row[3] <= D0_IMAGE
                  and min(row[2] - row[0], row[3] - row[1]) * scale > 2]
        own = []
        for y1, x1, y2, x2, cls, _score in sorted(inside, key=lambda row: -row[5])[:4]:
            x1, y1, x2, y2 = np.clip(np.array([x1, y1, x2, y2]) * scale
                                     + rng.uniform(-2, 2, 4), 0, TRAIN_IMAGE)
            own.append(f"{names[int(cls) - 1]},{x1:.1f},{y1:.1f},{x2:.1f},{y2:.1f}")
        count += len(own)
        own.append(f"{names[i % 4]},3,3,40,36")
        entries[next(order)["image_path"]] = own
    path = os.path.join(os.path.dirname(files["labels"]), "d0_own_labels.txt")
    with open(path, "w") as f:
        for label in labels:
            f.write(f"{os.path.basename(label['image_path'])}|"
                    f"{'|'.join(entries[label['image_path']])}|\n")
    return path, count


def phase_d0_eval(card, files, ckpt, seeded_pt):
    """The eval CLI with ``--family efficientdet`` through both kernels, in
    float32 with TF32 off: on the trained checkpoint against the set's labels
    and on the seeded serving weights (foreground predict biases spread over
    [0.5, 1.5), so that no two scores tie within rounding) against labels made
    from their own detections (mAP strictly between 0 and 1); then with the
    plain sweep (kept rows and mAPs identical), and with the plain sweep and the
    plain depthwise (kept rows of the same count and classes, boxes within 1e-3
    px, scores within 1e-5, equal mAPs)."""
    from tmv_tpu_torch.cli import eval_map
    from tmv_tpu_torch.kernels import dwconv, nms_sweep
    from tmv_tpu_torch.kernels.dwconv import dw_bn_swish_reference
    from tmv_tpu_torch.kernels.nms_sweep import greedy_sweep_reference

    import torch

    # the seeded serving load with its foreground predict biases spread over
    # [0.5, 1.5): at +1.0 the scores tie to ~1e-7, where the plain depthwise's
    # other summation order reorders them
    state = torch.load(seeded_pt, map_location="cpu", weights_only=True)
    bias = state["class_net.net.predict.pointwise.bias"].view(9, 81)
    bias[:, 1:] = torch.from_numpy(np.random.default_rng(15).uniform(0.5, 1.5, (9, 80)))
    spread_pt = os.path.join(WORK, "efficientdet_d0_seed0_spread.pt")
    torch.save(state, spread_pt)
    common = ["--family", "efficientdet", "--modelName", "efficientdet-d0", "--imagePath",
              files["images"], "--classesFile", files["classes"], "--imageSize",
              str(D0_IMAGE), "--batchSize", str(D0_TRAIN_BATCH), "--device", "cuda"]
    trained = common + ["--modelPath", ckpt, "--labelFile", files["labels"]]
    seeded = common + ["--modelPath", spread_pt]
    modes = ("batch", "global")

    def evaluate():
        records, _ = eval_map.efficientdet_records(eval_map.parse_args(trained))
        seeded_records, _ = eval_map.efficientdet_records(
            eval_map.parse_args(seeded + ["--labelFile", files["labels"]]))
        own_labels = write_d0_own_labels(files, seeded_records)
        own = {mode: eval_map.main(seeded + ["--mode", mode, "--labelFile", own_labels[0]])
               for mode in modes}
        maps = {mode: eval_map.main(trained + ["--mode", mode]) for mode in modes}
        return maps, records + seeded_records, own, own_labels

    dwconv.launches = nms_sweep.launches = 0
    maps, records, own, own_labels = evaluate()
    launches = {"dwconv_bn_swish": dwconv.launches, "nms_sweep": nms_sweep.launches}
    batches = 6 * TRAIN_SET // D0_TRAIN_BATCH
    check(launches["nms_sweep"] == batches,
          f"{launches['nms_sweep']} NMS launches for {batches} eval batches")
    check(launches["dwconv_bn_swish"] == 16 * batches,
          f"{launches['dwconv_bn_swish']} depthwise launches for {batches} eval forwards")
    own_argv = seeded + ["--labelFile", own_labels[0]]
    with mock.patch("tmv_tpu_torch.ops.nms.greedy_sweep", greedy_sweep_reference):
        plain, plain_records, plain_own = scored_records(
            eval_map.efficientdet_records, trained, own_argv, modes)
        with mock.patch("tmv_tpu_torch.models.efficientdet.backbone.fused_dw_bn_swish",
                        dw_bn_swish_reference):
            both, both_records, both_own = scored_records(
                eval_map.efficientdet_records, trained, own_argv, modes)
    # the plain sweep's re-run launches the depthwise kernel in its two passes, the
    # run with both plain versions launches neither
    check(nms_sweep.launches == launches["nms_sweep"]
          and dwconv.launches == launches["dwconv_bn_swish"] * 4 // 3,
          "the plain runs launched a kernel they replace")
    for name, got, want in (("trained", maps, plain), ("seeded", own, plain_own),
                            ("trained, plain depthwise", maps, both),
                            ("seeded, plain depthwise", own, both_own)):
        for mode in modes:
            check(got[mode]["mAP"] == want[mode]["mAP"] and got[mode]["images"] == TRAIN_SET,
                  f"D0 eval {mode} of the {name} model: kernels' mAP {got[mode]['mAP']} vs "
                  f"plain {want[mode]['mAP']}")
    check(all(a["prediction"] == b["prediction"] for a, b in zip(records, plain_records)),
          "D0 kept rows differ between the NMS kernel and the plain sweep")
    worst_box = worst_score = 0.0
    for a, b in zip(records, both_records):
        pa = np.asarray(a["prediction"]).reshape(-1, 6)
        pb = np.asarray(b["prediction"]).reshape(-1, 6)
        check(pa.shape == pb.shape and np.array_equal(pa[:, 4], pb[:, 4]),
              "D0 kept rows differ in count or class with the plain depthwise")
        if len(pa):
            worst_box = max(worst_box, float(np.abs(pa[:, :4] - pb[:, :4]).max()))
            worst_score = max(worst_score, float(np.abs(pa[:, 5] - pb[:, 5]).max()))
    check(worst_box <= 1e-3 and worst_score <= 1e-5,
          f"D0 kept rows with the plain depthwise: boxes {worst_box:.3g} px, scores "
          f"{worst_score:.3g} apart")
    check(own_labels[1] > 0 and all(0 < own[mode]["mAP"] < 1 for mode in modes),
          f"D0 eval on the seeded model's own labels ({own_labels[1]} boxes): mAP "
          f"{[own[m]['mAP'] for m in modes]} not in (0, 1)")
    kept = [sum(len(r["prediction"]) for r in part)
            for part in (records[:TRAIN_SET], records[TRAIN_SET:])]
    check(kept[1] > 0, f"the seeded D0 kept no box: {kept}")
    print(f"phase 14 D0 eval: tmv_tpu_torch.cli.eval_map --family efficientdet, {TRAIN_SET} "
          f"images @{D0_IMAGE} f32 (TF32 off) b{D0_TRAIN_BATCH}: the trained checkpoint on the "
          f"set's labels mAP batch {maps['batch']['mAP']:.4f}, global {maps['global']['mAP']:.4f}"
          f" ({kept[0]} boxes kept); the seeded weights on their own labels ({own_labels[1]} of "
          f"their kept boxes moved by up to 2 px, plus one missed box per image) batch "
          f"{own['batch']['mAP']:.4f}, global {own['global']['mAP']:.4f} ({kept[1]} boxes kept); "
          f"each equal with the plain sweep (kept rows identical) and with the plain sweep and "
          f"plain depthwise (kept rows of the same count and classes, boxes within "
          f"{worst_box:.3g} px, scores within {worst_score:.3g}); dwconv.launches "
          f"{launches['dwconv_bn_swish']} (16 x {batches} forwards), nms_sweep.launches "
          f"{launches['nms_sweep']} on [{card}]", flush=True)
    return launches


# ---------------------------------------------------------------- YOLOv3 family

class SweepLog:
    """Stands in for ``ops.nms.greedy_sweep`` and calls ``sweep`` (the kernel
    or the plain loop), keeping each call's whole kept mask and eligible count.
    The predictors cap their output at ``max_output_size`` rows, so only the
    sweep's own mask shows whether it suppressed candidates and whether two
    sweeps agree past the cap."""

    def __init__(self, sweep):
        self.sweep, self.masks, self.eligible = sweep, [], []

    def __call__(self, boxes, eligible, *args):
        kept = self.sweep(boxes, eligible, *args)
        self.masks.append(kept.cpu().numpy())
        self.eligible.append(eligible.sum(1).cpu().numpy())
        return kept

    def patch(self):
        return mock.patch("tmv_tpu_torch.ops.nms.greedy_sweep", self)

    def kept(self, calls=slice(None)):
        return [int(n) for m in self.masks[calls] for n in m.sum(1)]

    def eligibles(self, calls=slice(None)):
        return [int(n) for e in self.eligible[calls] for n in e]

    def same_masks(self, other):
        return len(self.masks) == len(other.masks) and all(
            np.array_equal(a, b) for a, b in zip(self.masks, other.masks))


def seeded_v3(version, device):
    """``--randomInit --seed 0`` weights of YOLOv3 or ResNetYoloV3 (80 classes,
    f32, eval mode) with the output convs' box rows scaled by the power of ten
    that brings the largest box logit of a seeded 416 image to at most 1:
    unscaled, the width/height logits overflow ``exp`` and no candidate decodes
    to a valid box. Returns (model, iou_type, the factor, the unscaled largest
    box logit)."""
    import torch

    from tmv_tpu_torch.models.detector_harness import build_yolo_model
    from tmv_tpu_torch.models.layers.common import init_weights

    model, iou_type = build_yolo_model(version, 80, device=device)
    init_weights(model, 0)
    model = model.to(memory_format=torch.channels_last).eval()
    image = np.random.default_rng(20).uniform(0, 1, (1, V3_IMAGE, V3_IMAGE, 3))
    heads = [model.DarknetConv_0, model.DarknetConv_1, model.DarknetConv_2]
    with torch.inference_mode():
        out = model(torch.from_numpy(image.astype(np.float32)).to(device))
        box_max = max(float(h.float().reshape(*h.shape[:3], 3, 85)[..., :4].abs().max())
                      for h in out)
    factor = 10.0 ** -np.ceil(np.log10(box_max)) if box_max > 1 else 1.0
    with torch.no_grad():
        for head in heads:
            rows = torch.arange(head.Conv_0.out_channels) % 85 < 4
            head.Conv_0.weight[rows] *= factor
            head.Conv_0.bias[rows] *= factor
    return model, iou_type, factor, box_max


def phase_v3_slice(card):
    """Phase 15: the YOLOv3 and ResNetYoloV3 slices at 416, f32 with TF32 off,
    B = 4: the batched predictor with the NMS kernel (IoU variant) and with the
    plain sweep give identical detections on a seeded load that gives NMS real
    work, and the card's heads agree with the CPU forward of the same
    state_dict. Returns the seeded v3 weights' path."""
    import torch

    from tmv_tpu_torch.kernels.nms_sweep import greedy_sweep, greedy_sweep_reference
    from tmv_tpu_torch.models.detector_harness import (
        build_yolo_model, make_yolo_predict_batched,
    )
    from tmv_tpu_torch.models.yolo_v4 import COCO_ANCHORS

    torch.backends.cudnn.deterministic = True
    paths = {}
    for version in ("v3", "resnet"):
        name = YOLO_NAMES[version]
        model, iou_type, factor, box_max = seeded_v3(version, "cuda")
        check(iou_type == "iou", f"{name} predicts with IoU NMS")
        paths[version] = os.path.join(WORK, f"{version}_seed0.pt")
        torch.save({k: v.cpu() for k, v in model.state_dict().items()}, paths[version])
        images = np.random.default_rng(21).uniform(0, 1, (4, V3_IMAGE, V3_IMAGE, 3))
        images = images.astype(np.float32)
        predict = make_yolo_predict_batched(model, (V3_IMAGE, V3_IMAGE), COCO_ANCHORS, 80,
                                            **V3_PREDICT_KW)
        kernel_log, plain_log = SweepLog(greedy_sweep), SweepLog(greedy_sweep_reference)
        with kernel_log.patch():
            got = predict(None, images)
        with plain_log.patch():
            want = predict(None, images)
        for g, w, what in zip(got, want, ("boxes", "ids", "scores", "valid")):
            check(np.array_equal(g, w), f"{name} slice {what} differ between kernel and plain")
        check(kernel_log.same_masks(plain_log),
              f"{name}: the sweeps' whole kept masks differ between kernel and plain")
        swept, eligible = kernel_log.kept(), kernel_log.eligibles()
        check(len(swept) == 4 and all(k < e for k, e in zip(swept, eligible)),
              f"{name}: the sweep suppressed nothing in an image (kept {swept} of "
              f"{eligible} eligible)")
        boxes, ids, scores, valid = got
        check(boxes.shape == (4, 500, 4) and valid.shape == (4, 500),
              f"{name} predictor output shapes")
        check((valid.sum(1) >= 1).all(), f"a {name} image kept no box")
        check(np.isfinite(boxes[valid]).all() and np.isfinite(scores[valid]).all(),
              f"non-finite {name} detections")
        check(((ids[valid] >= 0) & (ids[valid] < 80)).all(), f"{name} class ids out of range")
        with torch.inference_mode():
            card_heads = [h.float().cpu().numpy()
                          for h in model(torch.from_numpy(images).cuda())]
        print(f"phase 15 slice: {name} 80 classes @{V3_IMAGE} f32 B=4, IoU NMS: kernel and "
              f"plain sweep give identical detections and identical whole kept masks; per "
              f"image the sweep kept {swept} of the {eligible} eligible candidates in the "
              f"pre-NMS top 1024, the output the first {valid.sum(1).tolist()} of them (cap "
              f"500); seeded load: box rows of the three output convs x {factor:g} (largest "
              f"box logit of a seeded image {box_max:.3g} unscaled) on [{card}]", flush=True)
        cpu_model, _ = build_yolo_model(version, 80, device="cpu")
        cpu_model.load_state_dict(torch.load(paths[version], weights_only=True), strict=True)
        with torch.inference_mode():
            cpu_heads = [h.numpy() for h in cpu_model.eval()(torch.from_numpy(images[:1]))]
        rel = max(float(np.abs(g[:1] - w).max() / np.abs(w).max())
                  for g, w in zip(card_heads, cpu_heads))
        check(rel <= 1e-4, f"{name} card heads differ from the CPU forward: {rel:.3g}")
        print(f"phase 15 slice: {name} card heads vs CPU forward of the same state_dict: "
              f"max |diff| = {rel:.3g}·max|ref| (tolerance 1e-4) on [{card}]", flush=True)
        del model, cpu_model
    torch.backends.cudnn.deterministic = False
    return paths["v3"]


def phase_v3_serving(card, weights):
    """Phase 16: the port's server with ``--version v3 --bf16 --imageSize 416``
    on the seeded weights answers 10 seeded JPEGs through the NMS kernel; then
    the b1 image→boxes p50, the b16 images/s and the stage times at b1 and b16."""
    from tmv_tpu_torch.cli import serve
    from tmv_tpu_torch.models.yolo_v4 import COCO_ANCHORS

    classes_file, anchors_file = write_inputs(COCO_CLASSES, COCO_ANCHORS)
    args = serve.parse_args(["--version", "v3", "--modelPath", weights, "--classesFile",
                             classes_file, "--anchorsFile", anchors_file, "--imageSize",
                             str(V3_IMAGE), "--bf16", "--device", "cuda"])
    app, _, model = serve.build_app(args)
    check(all(p.device.type == "cuda" for p in model.parameters()), "v3 model is not on cuda")
    latencies, by_read, boxes_seen, launches = drive_server(app, 10, 5)
    check(launches["nms_sweep"] >= len(latencies),
          f"{launches['nms_sweep']} NMS launches for {len(latencies)} v3 requests")
    p50 = statistics.median(latencies)
    b1, ips = yolo_speed(model, V3_IMAGE, V3_PREDICT_KW)
    print(f"phase 16 v3 serving: {len(latencies)} requests -> HTTP 200 with the reference keys, "
          f"{boxes_seen} boxes; nms_sweep.launches {launches['nms_sweep']}; served p50 "
          f"{p50:.2f} ms (read=0 {statistics.median(by_read[0]):.2f} ms, read=1 "
          f"{statistics.median(by_read[1]):.2f} ms); numbers: YOLOv3 80 classes bf16 "
          f"@{V3_IMAGE}: b1 image->boxes p50 {b1:.2f} ms (50 runs), b16 batched predictor "
          f"{ips:.1f} images/s on [{card}]", flush=True)
    for batch in (1, 16):
        stages = yolo_stage_times(model, batch, size=V3_IMAGE, predict_kw=V3_PREDICT_KW)
        print(f"phase 16 stages on [{card}]: YOLOv3 80 classes bf16 @{V3_IMAGE} b{batch}: "
              + ", ".join(f"{k} {v:.2f} ms" for k, v in stages.items()), flush=True)
    return {"launches": launches["nms_sweep"], "p50": p50, "b1": b1, "ips": ips}


def phase_v3_train(card, files, seeded_weights):
    """Phase 17: the Darknet warm start, training, eval and serving of YOLOv3."""
    import torch

    from tmv_tpu_torch.cli import convert_darknet, serve, train_yolo
    from tmv_tpu_torch.convert.darknet import save_darknet_weights
    from tmv_tpu_torch.core.checkpoint import CheckpointManager, load_weights
    from tmv_tpu_torch.data.yolo_pipeline import YoloDataPipeline
    from tmv_tpu_torch.kernels import nms_sweep
    from tmv_tpu_torch.models.detector_harness import build_yolo_model
    from tmv_tpu_torch.models.yolo_v4 import COCO_ANCHORS

    # 1-2: the seeded v3 as a Darknet stream, converted to a checkpoint directory
    source, _ = build_yolo_model("v3", 80, device="cuda")
    source.load_state_dict(torch.load(seeded_weights, weights_only=True), strict=True)
    stream = os.path.join(WORK, "yolov3_seed0.weights")
    save_darknet_weights(source, stream, input_size=V3_IMAGE)
    converted = os.path.join(WORK, "yolov3_converted")
    convert_darknet.main(["--weights", stream, "--version", "v3", "--classesNum", "80",
                          "--imageSize", str(V3_IMAGE), "--out", converted, "--device", "cuda"])
    back, _ = build_yolo_model("v3", 80, device="cuda")
    check(load_weights(back, converted) == 0, "the converted checkpoint is not at step 0")
    want = {k: v for k, v in source.state_dict().items() if "num_batches" not in k}
    got = back.state_dict()
    check(all(torch.equal(got[k], v) for k, v in want.items()),
          "the converted stream does not load back to the same state_dict")
    print(f"phase 17 convert: save_darknet_weights wrote {os.path.getsize(stream)} bytes "
          f"({len(want)} tensors of the seeded v3); cli/convert_darknet.py -> step-0 checkpoint "
          f"directory; it loads back to the same state_dict exactly on [{card}]", flush=True)
    del back

    # 3: the CLI with the warm start; the module is read just after the warm-up
    ckpt = os.path.join(WORK, "yolov3_train")
    shutil.rmtree(ckpt, ignore_errors=True)
    warm = {}
    warm_start = train_yolo.warm_start

    def spy(model, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        warm_start(model, *args, **kwargs)
        torch.cuda.synchronize()
        warm["ms"] = (time.perf_counter() - t0) * 1e3 / V3_WARMUP
        warm["state"] = {k: v.detach().to("cpu", copy=True) for k, v in model.state_dict().items()}

    argv = ["--version", "v3", "--trainData", files["labels"], "--trainImagePath",
            files["images"], "--valData", files["val"], "--valImagePath", files["images"],
            "--classesFile", files["classes"], "--anchorsFile", files["anchors"],
            "--imageSize", str(TRAIN_IMAGE), "--batchSize", str(TRAIN_BATCH), "--bf16",
            "--stepsPerEpoch", str(V3_STEPS_PER_EPOCH), "--epochs", "2", "--lr", "5e-4",
            "--darknetWeights", stream, "--warmupSteps", str(V3_WARMUP),
            "--modelPath", ckpt, "--device", "cuda"]
    nms_sweep.launches = 0
    t0 = time.perf_counter()
    with mock.patch.object(train_yolo, "warm_start", spy):
        out = train_yolo.main(argv)
    wall = time.perf_counter() - t0
    val_launches = nms_sweep.launches
    steps = 2 * V3_STEPS_PER_EPOCH
    check(out["step"] == steps, f"the v3 CLI took {out['step']} steps")
    check(val_launches >= 2 * VAL_SET, f"{val_launches} NMS launches in the v3 val passes")
    head = ("DarknetConv_0.", "DarknetConv_1.", "DarknetConv_2.")
    params = {n for n, _ in source.named_parameters()}
    frozen = [n for n in params if not n.startswith(head)]
    check(all(torch.equal(warm["state"][n], want[n].cpu()) for n in frozen),
          "a frozen parameter moved in the warm-up")
    check(all(not torch.equal(warm["state"][n], want[n].cpu()) for n in params - set(frozen)),
          "an output conv did not move in the warm-up")
    stats = [n for n in want if n.endswith(("running_mean", "running_var"))]
    moved = sum(not torch.equal(warm["state"][n], want[n].cpu()) for n in stats)
    check(moved == len(stats), f"{len(stats) - moved} BatchNorm statistics did not move")
    with open(os.path.join(ckpt, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    check([r["step"] for r in records] == list(range(steps)), "the main phase did not start at 0")
    saved = torch.load(CheckpointManager(ckpt).path(steps), map_location="cpu", weights_only=True)
    adam_steps = {int(v["step"]) for v in saved["optimizer"]["state"].values()}
    check(adam_steps == {steps}, f"the main Adam state did not start fresh: steps {adam_steps}")
    host_step = statistics.median(r["step_time_s"] for r in records[steps // 4:]) * 1e3
    print(f"phase 17 warm start: train_yolo --version v3 --bf16 --darknetWeights (the stream) "
          f"--warmupSteps {V3_WARMUP}, then {steps} steps b{TRAIN_BATCH} @{TRAIN_IMAGE} in "
          f"{wall:.1f} s; after the warm-up {len(frozen)} frozen parameters bit-equal to the "
          f"stream, the {len(params) - len(frozen)} output-conv tensors moved, {moved} of "
          f"{len(stats)} BatchNorm statistics moved; warm-up {warm['ms']:.2f} ms per step "
          f"(host clock, pipeline included); main phase from step 0 with a fresh Adam (step "
          f"count {steps} at the end), raw loss first {records[0]['raw_loss']:.2f}, last "
          f"{records[-1]['raw_loss']:.2f}, host step p50 {host_step:.2f} ms; val mAP "
          f"{[round(m, 4) for m in out['val_mAP']]}; nms_sweep.launches {val_launches} on "
          f"[{card}]", flush=True)

    # 4: an overfit of one fixed batch
    state, _, step, anchors = train_setup(files, torch.bfloat16, "cuda", seed=1, version="v3")
    pipeline = YoloDataPipeline(files["images"], files["labels"], files["classes"],
                                TRAIN_BATCH, anchors, image_wh=(TRAIN_IMAGE, TRAIN_IMAGE),
                                prefetch=0, device="cuda")
    batches = iter(pipeline)
    batch = next(batches)
    batches.close()
    for _ in range(3):
        step(state, batch)
    step_ms = cuda_ms(lambda: step(state, batch), 5)
    state, _, step, _ = train_setup(files, torch.bfloat16, "cuda", seed=1, version="v3")
    overfit = [float(step(state, batch)["raw_loss"]) for _ in range(OVERFIT_STEPS)]
    check(all(np.isfinite(overfit)), "non-finite loss in the v3 overfit")
    check(overfit[-1] <= overfit[0] / 2,
          f"overfitting one batch (v3): raw loss {overfit[0]:.2f} -> {overfit[-1]:.2f}")
    print(f"phase 17 overfit of one fixed batch, {OVERFIT_STEPS} steps YOLOv3 bf16 lr 5e-4: raw "
          f"loss {overfit[0]:.2f} -> {overfit[-1]:.2f} ({overfit[0] / overfit[-1]:.1f}x lower; "
          f"required >= 2x); the step {step_ms:.2f} ms by CUDA events over 5 steps "
          f"({TRAIN_BATCH * 1e3 / step_ms:.1f} images/s) on [{card}]", flush=True)
    del state, batch

    # 5: float32 against float64
    f32 = phase_train_f32(card, files, anchors, version="v3", phase=17)

    # 6: the eval CLI, kernel and plain sweep
    eval_launches, kept = phase_v3_eval(card, files, ckpt, converted)

    # 7: serve the trained checkpoint directory
    classes_file, anchors_file = write_inputs(COCO_CLASSES, COCO_ANCHORS)
    args = serve.parse_args(["--version", "v3", "--modelPath", ckpt, "--classesFile",
                             classes_file, "--anchorsFile", anchors_file, "--imageSize",
                             str(V3_IMAGE), "--bf16", "--device", "cuda"])
    app, _, _ = serve.build_app(args)
    latencies, _, boxes_seen, launches = drive_server(app, 1, 7)
    check(launches["nms_sweep"] >= 1, "serving the trained v3 launched no NMS")
    print(f"phase 17 serve: cli/serve.py --version v3 --modelPath {os.path.basename(ckpt)}/ "
          f"(the trainer's checkpoint directory, step {steps}) answered 1 request in "
          f"{latencies[0]:.2f} ms ({boxes_seen} boxes); nms_sweep.launches "
          f"{launches['nms_sweep']} on [{card}]", flush=True)
    return {"launches": val_launches + eval_launches + launches["nms_sweep"],
            "val": val_launches, "eval": eval_launches, "serve": launches["nms_sweep"],
            "warm_ms": warm["ms"], "step_ms": step_ms, "host_step": host_step, "f32": f32,
            "kept": kept}


def phase_v3_eval(card, files, ckpt, converted):
    """``cli/eval_map.py --version v3`` in both modes, with the NMS kernel and
    with the plain sweep: on the trained checkpoint directory against the set's
    labels, and on the converted checkpoint directory (the seeded load) against
    labels made from its own detections (mAP strictly between 0 and 1); equal
    mAPs and identical kept rows."""
    from tmv_tpu_torch.cli import eval_map
    from tmv_tpu_torch.kernels import nms_sweep
    from tmv_tpu_torch.kernels.nms_sweep import greedy_sweep, greedy_sweep_reference

    common = ["--family", "yolo", "--version", "v3", "--imagePath", files["images"],
              "--classesFile", files["classes"], "--anchorsFile", files["anchors"],
              "--imageSize", str(TRAIN_IMAGE), "--confidenceThresh", "0.2",
              "--scoresThresh", "0.05", "--batchSize", "8", "--bf16", "--device", "cuda"]
    trained = common + ["--modelPath", ckpt, "--labelFile", files["labels"]]
    seeded = common + ["--modelPath", converted]
    modes = ("batch", "global")

    def evaluate():
        records, _ = eval_map.predict_records(eval_map.parse_args(trained))
        seeded_records, _ = eval_map.predict_records(
            eval_map.parse_args(seeded + ["--labelFile", files["labels"]]))
        own_labels = write_own_labels(files, seeded_records, "v3_own_labels.txt")
        maps = {mode: eval_map.main(trained + ["--mode", mode]) for mode in modes}
        own = {mode: eval_map.main(seeded + ["--mode", mode, "--labelFile", own_labels[0]])
               for mode in modes}
        return maps, records + seeded_records, own, own_labels

    kernel_log, plain_log = SweepLog(greedy_sweep), SweepLog(greedy_sweep_reference)
    nms_sweep.launches = 0
    with kernel_log.patch():
        maps, records, own, own_labels = evaluate()
    launches = nms_sweep.launches
    with plain_log.patch():
        plain, plain_records, plain_own = scored_records(
            eval_map.predict_records, trained, seeded + ["--labelFile", own_labels[0]], modes)
    batches = 6 * TRAIN_SET // 8
    check(launches >= batches, f"{launches} NMS launches for {batches} v3 eval batches")
    check(nms_sweep.launches == launches, "the plain sweep launched the kernel")
    # evaluate()'s calls in order: 8 batches each of the trained, the converted,
    # the trained twice and the converted twice; the plain pass: the first two
    per = TRAIN_SET // 8
    check(len(plain_log.masks) == 2 * per and all(
        np.array_equal(a, b) for a, b in zip(kernel_log.masks[:2 * per], plain_log.masks)),
        "v3 eval: the sweeps' whole kept masks differ between kernel and plain")
    check(len(kernel_log.masks) == 6 * per, f"{len(kernel_log.masks)} sweeps in the v3 eval")
    calls = {"trained": [slice(0, per), slice(2 * per, 4 * per)],
             "converted": [slice(per, 2 * per), slice(4 * per, 6 * per)]}
    suppressed = {}
    for name, parts in calls.items():
        kept_n = sum(sum(kernel_log.kept(c)) for c in parts)
        eligible_n = sum(sum(kernel_log.eligibles(c)) for c in parts)
        suppressed[name] = (eligible_n - kept_n, eligible_n)
    # the converted checkpoint is phase 15's seeded load, whose anchor-sized
    # boxes overlap their neighbours; the trained one's need not (printed below)
    check(suppressed["converted"][0] > 0,
          f"v3 eval of the converted checkpoint: the sweep suppressed nothing "
          f"({suppressed['converted'][1]} eligible)")
    rows = np.array([row for r in records[:TRAIN_SET] for row in r["prediction"]]).reshape(-1, 6)
    trained_wh = np.median(rows[:, 2:4] - rows[:, 0:2], axis=0) * TRAIN_IMAGE
    for name, got, want in (("trained", maps, plain), ("converted", own, plain_own)):
        for mode in modes:
            check(got[mode]["mAP"] == want[mode]["mAP"] and got[mode]["images"] == TRAIN_SET,
                  f"v3 eval {mode} of the {name} model: kernel mAP {got[mode]['mAP']} vs "
                  f"plain {want[mode]['mAP']}")
    check(own_labels[1] > 0 and all(0 < own[mode]["mAP"] < 1 for mode in modes),
          f"v3 eval on the converted model's own labels ({own_labels[1]} boxes): mAP "
          f"{[own[m]['mAP'] for m in modes]} not in (0, 1)")
    kept = [sum(len(r["prediction"]) for r in part)
            for part in (records[:TRAIN_SET], records[TRAIN_SET:])]
    check(kept[1] > 0, f"the converted v3 kept no box: {kept}")
    check(all(a["prediction"] == b["prediction"] for a, b in zip(records, plain_records)),
          "v3 kept rows differ between the kernel and the plain sweep")
    print(f"phase 17 eval: tmv_tpu_torch.cli.eval_map --version v3, {TRAIN_SET} images "
          f"@{TRAIN_IMAGE} bf16 b8: the trained checkpoint on the set's labels mAP batch "
          f"{maps['batch']['mAP']:.4f}, global {maps['global']['mAP']:.4f} ({kept[0]} boxes "
          f"kept); the converted checkpoint on its own labels ({own_labels[1]} of its kept "
          f"boxes moved by up to 2 px, plus one missed box per image) batch "
          f"{own['batch']['mAP']:.4f}, global {own['global']['mAP']:.4f} ({kept[1]} boxes "
          f"kept); each equal with the plain sweep, kept rows and whole sweep masks "
          f"identical; the sweep suppressed {suppressed['trained'][0]} of "
          f"{suppressed['trained'][1]} eligible candidates (trained: kept boxes of median "
          f"{trained_wh[0]:.1f} x {trained_wh[1]:.1f} px in {len(np.unique(rows[:, 4]))} "
          f"classes) and {suppressed['converted'][0]} of {suppressed['converted'][1]} "
          f"(converted) over the passes; nms_sweep.launches {launches} on [{card}]",
          flush=True)
    return launches, kept



# ------------------------------------------------- slice 7: mosaic, UNet, serving

def write_anchors(files, size):
    """The COCO anchors scaled by ``size / 416``, as an anchors file."""
    from tmv_tpu_torch.models.yolo_v4 import COCO_ANCHORS

    scaled = np.round(COCO_ANCHORS * size / TRAIN_IMAGE).astype(np.int64)
    path = os.path.join(os.path.dirname(files["anchors"]), f"anchors_{size}.txt")
    with open(path, "w") as f:
        f.write(",".join(str(int(v)) for v in scaled[::-1].reshape(-1)))
    return path


def mosaic_setup(anchors, dtype, seed, remat=False):
    """YOLOv4 at 608 (80 classes) on the card, its train state and step."""
    import torch

    from tmv_tpu_torch.core.train_state import TrainState, make_train_step
    from tmv_tpu_torch.models.detector_harness import build_yolo_model, make_yolo_loss_fn
    from tmv_tpu_torch.models.layers.common import init_weights

    model, _ = build_yolo_model("v4", 80, dtype=dtype, device="cuda",
                                param_dtype=torch.float32, remat=remat)
    init_weights(model, seed)
    model = model.to(memory_format=torch.channels_last)
    state = TrainState.create(model, torch.optim.Adam(model.parameters(), lr=5e-4))
    loss_fn = make_yolo_loss_fn((MOSAIC_IMAGE, MOSAIC_IMAGE), anchors, iou_type="ciou")
    return state, loss_fn, make_train_step(loss_fn, shadow_loss=True)


def phase_mosaic_train(card, files):
    """Phase 18: YOLOv4 @608 with mosaic through the trainer CLI and the staging
    cache, mosaic on the card against the CPU, the step with and without remat."""
    import torch

    from tmv_tpu_torch.cli import train_yolo
    from tmv_tpu_torch.data.loaders import load_anchors
    from tmv_tpu_torch.data.mosaic import draw_mosaic_params, mosaic_batch
    from tmv_tpu_torch.data.yolo_pipeline import YoloDataPipeline
    from tmv_tpu_torch.kernels import nms_sweep

    anchors_file = write_anchors(files, MOSAIC_IMAGE)
    anchors = load_anchors(anchors_file)
    ckpt = os.path.join(WORK, "yolov4_608_mosaic")
    cache = os.path.join(WORK, "stage_cache_608")
    for d in (ckpt, cache):
        shutil.rmtree(d, ignore_errors=True)
    argv = ["--version", "v4", "--trainData", files["labels"], "--trainImagePath",
            files["images"], "--valData", files["val"], "--valImagePath", files["images"],
            "--classesFile", files["classes"], "--anchorsFile", anchors_file,
            "--imageSize", str(MOSAIC_IMAGE), "--mosaic", "1.0", "--cacheDir", cache, "--bf16",
            "--batchSize", str(TRAIN_BATCH), "--stepsPerEpoch", str(MOSAIC_STEPS_PER_EPOCH),
            "--epochs", "2", "--lr", "5e-4", "--modelPath", ckpt, "--device", "cuda"]
    staged = []            # (image path, served from the cache) of the cached pipeline
    real_stage = YoloDataPipeline.stage_one

    def stage(self, label):
        if self.cache is not None:
            staged.append((label["image_path"], self.cache.get(label["_cache_row"]) is not None))
        return real_stage(self, label)

    torch.cuda.reset_peak_memory_stats()
    nms_sweep.launches = 0
    t0 = time.perf_counter()
    with mock.patch.object(YoloDataPipeline, "stage_one", stage):
        out = train_yolo.main(argv)
    wall = time.perf_counter() - t0
    val_launches = nms_sweep.launches
    cli_peak = torch.cuda.max_memory_allocated() / 2**30
    with open(os.path.join(ckpt, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    steps = 2 * MOSAIC_STEPS_PER_EPOCH
    check(out["step"] == steps and len(records) == steps, f"the 608 CLI took {out['step']} steps")
    check(all(np.isfinite(r["loss"]) and np.isfinite(r["raw_loss"]) for r in records),
          "a non-finite loss at 608 with mosaic")
    check(len(out["val_mAP"]) == 2 and val_launches >= 2 * VAL_SET,
          f"608 val passes: {out['val_mAP']}, {val_launches} NMS launches")
    per_epoch = MOSAIC_STEPS_PER_EPOCH * TRAIN_BATCH
    first, second = staged[:per_epoch], staged[per_epoch:2 * per_epoch]
    seen = {p for p, _ in first}
    decoded_again = [p for p, hit in second if not hit and p in seen]
    check(not decoded_again, f"epoch 2 decoded {len(decoded_again)} images epoch 1 had cached")
    decodes = [sum(not hit for _, hit in part) for part in (first, second)]
    host_step = statistics.median(r["step_time_s"] for r in records[2:]) * 1e3
    print(f"phase 18 train CLI: YOLOv4 80 classes @{MOSAIC_IMAGE} b{TRAIN_BATCH} bf16 --mosaic "
          f"1.0 --cacheDir, anchors x{MOSAIC_IMAGE}/{TRAIN_IMAGE}: {steps} steps in {wall:.1f} s "
          f"with two val passes of {VAL_SET} images; raw loss first {records[0]['raw_loss']:.2f}, "
          f"last {records[-1]['raw_loss']:.2f}; val mAP {[round(m, 4) for m in out['val_mAP']]}; "
          f"host step time p50 {host_step:.2f} ms; decodes per epoch {decodes} of {per_epoch} "
          f"stagings ({len(seen)} distinct images in epoch 1, none decoded again in epoch 2); "
          f"nms_sweep.launches in the val passes {val_launches}; peak memory {cli_peak:.2f} GiB "
          f"on [{card}]", flush=True)

    # the cache over whole passes of the set, against uncached staging
    pipeline = YoloDataPipeline(files["images"], files["labels"], files["classes"], TRAIN_BATCH,
                                anchors, image_wh=(MOSAIC_IMAGE, MOSAIC_IMAGE), mosaic=1.0,
                                cache_dir=cache, device="cuda")
    labels = pipeline.labels
    count = {"decode": 0}
    real_decode = pipeline.stage_one_uncached

    def decode(label):
        count["decode"] += 1
        return real_decode(label)

    pipeline.stage_one_uncached = decode
    passes = []
    with ThreadPoolExecutor(TRAIN_BATCH) as pool:
        for _ in range(2):
            count["decode"] = 0
            rows = [pipeline.stage_batch(labels[i:i + TRAIN_BATCH], pool)
                    for i in range(0, len(labels), TRAIN_BATCH)]
            passes.append((count["decode"], rows))
        check(passes[1][0] == 0, f"the second pass over the set decoded {passes[1][0]} images")
        for i, row in zip(range(0, len(labels), TRAIN_BATCH), passes[1][1]):
            fresh = [real_decode(lb) for lb in labels[i:i + TRAIN_BATCH]]
            for got, want in zip(row, (np.stack(z) for z in zip(*fresh))):
                check(np.array_equal(got, want), "a cached frame differs from uncached staging")
        batch_labels = labels[:TRAIN_BATCH]
        cached_ms = host_ms(lambda: pipeline.stage_batch(batch_labels, pool), 5)
        plain = YoloDataPipeline(files["images"], files["labels"], files["classes"],
                                 TRAIN_BATCH, anchors, image_wh=(MOSAIC_IMAGE, MOSAIC_IMAGE),
                                 device="cuda")
        uncached_ms = host_ms(lambda: plain.stage_batch(batch_labels, pool), 5)
        staged_batch = pipeline.stage_batch(batch_labels, pool)
    print(f"phase 18 staging cache: a pass over the {len(labels)} images decoded "
          f"{passes[0][0]} (those the CLI had not staged), the next pass {passes[1][0]}, its "
          f"frames and labels bit-equal to uncached staging; host staging of a batch of "
          f"{TRAIN_BATCH} ({TRAIN_BATCH} threads, median of 5): {uncached_ms:.2f} ms decoding, "
          f"{cached_ms:.2f} ms from the cache on [{card}]", flush=True)

    # mosaic on the card against the CPU, same draws
    draws = draw_mosaic_params(torch.Generator().manual_seed(18), TRAIN_BATCH,
                               (MOSAIC_IMAGE, MOSAIC_IMAGE))
    host = [torch.from_numpy(a) for a in staged_batch]
    want = mosaic_batch(*host, *draws)
    got = [t.cpu() for t in mosaic_batch(*(t.cuda() for t in host), *draws)]
    pixel_steps = int((got[0].int() - want[0].int()).abs().max())
    check(all(torch.equal(g, w) for g, w in zip(got[1:], want[1:])),
          "mosaic boxes, classes or valid differ between the card and the CPU")
    check(pixel_steps <= 1, f"mosaic pixels differ by {pixel_steps} uint8 steps")
    mosaic_ms = cuda_ms(lambda: mosaic_batch(*(t.cuda() for t in host), *draws), 5)
    print(f"phase 18 mosaic card vs CPU (b{TRAIN_BATCH} uint8 @{MOSAIC_IMAGE}, one set of "
          f"draws): boxes, classes and valid identical, pixels within {pixel_steps} uint8 "
          f"step(s) (tolerance 1), {int(got[3].sum())} valid boxes; mosaic_batch with its H2D "
          f"{mosaic_ms:.2f} ms on [{card}]", flush=True)

    # the step with and without remat
    it = iter(pipeline)
    batch = next(it)
    it.close()
    timing = {}
    for remat in (False, True):
        state, _, step = mosaic_setup(anchors, torch.bfloat16, 0, remat)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        for _ in range(2):
            step(state, batch)
        ms = cuda_ms(lambda: step(state, batch), 5)
        timing[remat] = (ms, (torch.cuda.max_memory_allocated() - base) / 2**30,
                         torch.cuda.max_memory_allocated() / 2**30,
                         step_kernel_ms(lambda: step(state, batch), 3))
        del state, step
        torch.cuda.empty_cache()
    check(timing[True][1] < timing[False][1], f"remat did not lower the peak memory: {timing}")
    # float32, TF32 off: the step without remat twice (its own run-to-run spread:
    # atomics in the loss's scatter) and with remat once, from one state_dict
    results = []
    torch.backends.cudnn.deterministic = True
    try:
        for remat in (False, False, True):
            state, loss_fn, _ = mosaic_setup(anchors, torch.float32, 2, remat)
            model = state.model.train()
            loss, _ = loss_fn(model, {"image": batch["image"], "targets": batch["targets"]})
            loss.backward()
            results.append((loss.item(), grads_of(model)))
            del state, model, loss
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = False
    (direct, _), (again, _), (with_remat, _) = results
    spread, grad_err = rel_l2(results[1][1], results[0][1]), rel_l2(results[2][1], results[0][1])
    loss_diff = abs(with_remat - direct)
    check(loss_diff <= 2 * abs(again - direct) + 1e-6 * abs(direct)
          and grad_err[1] <= 2 * spread[1] + 1e-6,
          f"remat f32 step: loss {with_remat} vs {direct} (again {again}), gradients "
          f"{grad_err} against the spread {spread}")
    results = {False: results[0], True: results[2]}
    print(f"phase 18 remat on [{card}]: YOLOv4 80 classes @{MOSAIC_IMAGE} b{TRAIN_BATCH} bf16 "
          f"(mosaic batch): step {timing[False][0]:.2f} ms without, {timing[True][0]:.2f} ms "
          f"with remat (CUDA events, 5 steps after 2); step peak memory above the resident "
          f"state {timing[False][1]:.2f} GiB without, {timing[True][1]:.2f} GiB with remat "
          f"(process peak {timing[False][2]:.2f} / {timing[True][2]:.2f} GiB); kernels' device "
          f"time per step (torch.profiler, 3 steps) {timing[False][3]:.2f} ms without, "
          f"{timing[True][3]:.2f} ms with remat; float32 step "
          f"(TF32 off, deterministic cuDNN) loss {results[False][0]:.6f} without, "
          f"{results[True][0]:.6f} with remat (difference {loss_diff:.3g}; the step without "
          f"remat run twice differs by {abs(again - direct):.3g}), gradients' relative L2 "
          f"difference with remat: overall {grad_err[0]:.3g}, worst tensor {grad_err[1]:.3g}; "
          f"without remat twice: {spread[0]:.3g}, {spread[1]:.3g} (tolerance: within 2x that "
          f"spread + 1e-6)", flush=True)
    return {"ckpt": ckpt, "anchors_file": anchors_file, "val_launches": val_launches,
            "timing": timing, "grad_err": grad_err}


def write_labelme_set(root, count=UNET_SET):
    """``count`` seeded 240 x 180 JPEGs, each a gradient with one filled
    quadrilateral, and a labelme JSON per image holding its 4 corners."""
    from PIL import Image, ImageDraw

    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(19)
    h, w = 180, 240
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 255 // w, y * 255 // h, np.full_like(x, 90)], -1).astype(np.uint8)
    for i in range(count):
        im = Image.fromarray(base)
        cx, cy = rng.uniform(90, 150), rng.uniform(70, 110)
        hw, hh = rng.uniform(40, 70), rng.uniform(30, 50)
        quad = [(cx + sx * hw + rng.uniform(-8, 8), cy + sy * hh + rng.uniform(-8, 8))
                for sx, sy in ((-1, -1), (1, -1), (1, 1), (-1, 1))]
        ImageDraw.Draw(im).polygon(quad, fill=tuple(int(v) for v in rng.integers(0, 256, 3)))
        im.save(os.path.join(root, f"doc{i}.jpg"), quality=90)
        with open(os.path.join(root, f"doc{i}.json"), "w") as f:
            json.dump({"imagePath": f"doc{i}.jpg",
                       "shapes": [{"label": "doc", "points": [list(p) for p in quad]}]}, f)
    return root


def unet_setup(filters_base, device, dtype=None, seed=0, lr=1e-3):
    """UNetLogits at the CLI's depth 4 and 4 points, its Adam state and step."""
    import torch

    from tmv_tpu_torch.core.train_state import TrainState, make_train_step
    from tmv_tpu_torch.models.unet import UNetLogits, init_weights, make_unet_loss_fn

    model = init_weights(UNetLogits(4, filters_base, 4), seed)
    model = model.to(device=device, dtype=dtype or torch.float32,
                     memory_format=torch.channels_last)
    state = TrainState.create(model, torch.optim.Adam(model.parameters(), lr=lr))
    return state, make_unet_loss_fn(), make_train_step(make_unet_loss_fn(),
                                                       clip_global_norm=10.0)


def phase_unet(card):
    """Phase 19: UNet @128 through cli/train_unet.py at its defaults, its step's
    numbers at widths 16 and 64, an overfit, float32 against float64, a resume."""
    import torch

    from tmv_tpu_torch.cli import train_unet
    from tmv_tpu_torch.data.unet_dataset import get_dataset

    root = write_labelme_set(os.path.join(WORK, "unet_set"))
    ckpt = os.path.join(WORK, "unet_train")
    shutil.rmtree(ckpt, ignore_errors=True)
    argv = ["--labelPath", root, "--steps", str(UNET_STEPS), "--dumpEvery",
            str(UNET_STEPS // 2), "--modelPath", ckpt, "--device", "cuda"]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = train_unet.main(argv)
    wall = time.perf_counter() - t0
    check(out["step"] == UNET_STEPS and all(np.isfinite(out["losses"])),
          f"the UNet CLI: step {out['step']}, losses {out['losses'][:3]}")
    windows = (UNET_STEPS // 2 - 1, UNET_STEPS - 1)
    dumps = sorted(os.listdir(os.path.join(ckpt, "dumps")))
    want = sorted([f"in_{i}.jpg" for i in windows] + [f"{k}_{i}_{c}.jpg" for k in ("pred", "target")
                                                       for i in windows for c in range(4)])
    check(dumps == want, f"UNet dumps {dumps}")
    saved = sorted(f for f in os.listdir(ckpt) if f.endswith(".pt"))
    check(saved == sorted(f"{i + 1}.pt" for i in windows), f"UNet checkpoints {saved}")
    again = train_unet.main(argv[:3] + [str(UNET_STEPS + 5)] + argv[4:])
    check(again["step"] == UNET_STEPS + 5 and len(again["losses"]) == 5,
          f"the UNet resume took {again['step']} steps")
    print(f"phase 19 UNet CLI: @128 depth 4 width 16 4 points b4 float32 (the CLI's "
          f"defaults), {UNET_STEPS} steps in {wall:.1f} s, loss {out['losses'][0]:.4f} -> "
          f"{out['losses'][-1]:.4f}, checkpoints {saved}, {len(dumps)} dump images; resumed "
          f"from step {UNET_STEPS} to {again['step']} ({again['losses'][-1]:.4f}) on [{card}]",
          flush=True)

    batches, _ = get_dataset(root, 4, 4, (128, 128), (128, 128))
    host = next(batches)
    batch = {k: v.cuda() for k, v in host.items()}
    numbers = {}
    for width in (16, 64):
        state, _, step = unet_setup(width, "cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        for _ in range(3):
            step(state, batch)
        ms = cuda_ms(lambda: step(state, batch), 10)
        numbers[width] = (ms, (torch.cuda.max_memory_allocated() - base) / 2**20,
                          sum(p.numel() for p in state.model.parameters()),
                          step_kernel_ms(lambda: step(state, batch), 3))
        del state
    state, _, step = unet_setup(16, "cuda", seed=1, lr=1e-2)
    overfit = [float(step(state, batch)["raw_loss"]) for _ in range(OVERFIT_STEPS)]
    check(all(np.isfinite(overfit)) and overfit[-1] <= overfit[0] / 2,
          f"UNet overfit: loss {overfit[0]:.4f} -> {overfit[-1]:.4f}")
    del state
    results = {}
    for name, device, dtype in (("card", "cuda", torch.float32), ("cpu", "cpu", torch.float32),
                                ("cpu f64", "cpu", torch.float64)):
        state, loss_fn, _ = unet_setup(16, device, dtype, seed=2)
        model = state.model.train()
        loss, _ = loss_fn(model, {k: v.to(device, dtype) for k, v in host.items()})
        loss.backward()
        results[name] = (loss.item(), {n: p.grad.detach().cpu().double()
                                       for n, p in model.named_parameters()
                                       if p.grad is not None})
        del state, model
    (card_loss, card_g), (cpu_loss, cpu_g), (ref_loss, ref_g) = (
        results[k] for k in ("card", "cpu", "cpu f64"))
    loss_rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    card_err, cpu_err = rel_l2(card_g, ref_g), rel_l2(cpu_g, ref_g)
    check(loss_rel <= 1e-3, f"UNet f32 loss card {card_loss} vs CPU {cpu_loss}")
    check(card_err[0] <= 2 * cpu_err[0] + 1e-4 and card_err[1] <= 2 * cpu_err[1] + 1e-4,
          f"UNet f32 gradients: card vs float64 {card_err}, CPU vs float64 {cpu_err}")
    print(f"phase 19 UNet step on [{card}]: @128 b4 depth 4 float32 (CUDA events, 10 steps "
          f"after 3): width 16 ({numbers[16][2]} parameters) {numbers[16][0]:.2f} ms "
          f"({4e3 / numbers[16][0]:.1f} images/s), peak above the resident state "
          f"{numbers[16][1]:.1f} MiB, kernels' device time per step (torch.profiler, 3 steps) "
          f"{numbers[16][3]:.2f} ms; width 64 ({numbers[64][2]} parameters) "
          f"{numbers[64][0]:.2f} ms ({4e3 / numbers[64][0]:.1f} images/s), "
          f"{numbers[64][1]:.1f} MiB, kernels {numbers[64][3]:.2f} ms; overfit of one batch, {OVERFIT_STEPS} steps lr 1e-2: "
          f"loss {overfit[0]:.4f} -> {overfit[-1]:.4f} ({overfit[0] / overfit[-1]:.1f}x; "
          f"required >= 2x); f32 step (TF32 off): loss card {card_loss:.6f}, CPU "
          f"{cpu_loss:.6f} (relative {loss_rel:.3g}), float64 {ref_loss:.6f}; gradients' "
          f"relative L2 error against float64 (overall, worst tensor): card {card_err[0]:.3g}, "
          f"{card_err[1]:.3g}; CPU float32 {cpu_err[0]:.3g}, {cpu_err[1]:.3g}", flush=True)
    return {"numbers": numbers, "overfit": (overfit[0], overfit[-1]), "card_err": card_err,
            "cpu_err": cpu_err}


def wsgi_application(env):
    """``tmv_tpu_torch.serving.wsgi.application`` built anew from ``env``."""
    import importlib

    with mock.patch.dict(os.environ, env):
        sys.modules.pop("tmv_tpu_torch.serving.wsgi", None)
        return importlib.import_module("tmv_tpu_torch.serving.wsgi").application


def phase_serving_extras(card, files, mosaic, d0_ckpt):
    """Phase 20: the WSGI module from the environment on phase 18's and phase
    13's checkpoint directories, and cli/detect.py for both families."""
    from tmv_tpu_torch.cli import detect
    from tmv_tpu_torch.kernels import dwconv, nms_sweep

    common = {"TMV_CLASSES_FILE": files["classes"], "TMV_BF16": "1", "TMV_DEVICE": "cuda"}
    yolo_env = dict(common, TMV_MODEL_PATH=mosaic["ckpt"], TMV_FAMILY="yolo", TMV_VERSION="v4",
                    TMV_ANCHORS_FILE=mosaic["anchors_file"], TMV_IMAGE_SIZE=str(MOSAIC_IMAGE))
    d0_env = dict(common, TMV_MODEL_PATH=d0_ckpt, TMV_FAMILY="efficientdet",
                  TMV_MODEL_NAME="efficientdet-d0", TMV_IMAGE_SIZE=str(D0_IMAGE))
    served = {}
    for name, env, count in (("YOLOv4 @608", yolo_env, 6), ("D0 @512", d0_env, 4)):
        latencies, _, boxes, launches = drive_server(wsgi_application(env), count, seed=20)
        check(launches["nms_sweep"] >= count, f"WSGI {name}: {launches} for {count} requests")
        if name.startswith("D0"):
            check(launches["dwconv_bn_swish"] == 16 * count,
                  f"WSGI {name}: {launches['dwconv_bn_swish']} depthwise launches")
        served[name] = (statistics.median(latencies), boxes, launches)
    image = os.path.join(WORK, "detect_in.jpg")
    with open(image, "wb") as f:
        f.write(scene_jpeg(np.random.default_rng(20), 480, 640))
    detected = {}
    for name, extra in (("yolo", ["--anchorsFile", mosaic["anchors_file"], "--modelPath",
                                  mosaic["ckpt"], "--imageSize", str(MOSAIC_IMAGE)]),
                        ("efficientdet", ["--family", "efficientdet", "--modelPath", d0_ckpt,
                                          "--imageSize", str(D0_IMAGE)])):
        out = os.path.join(WORK, f"detect_{name}.jpg")
        if os.path.exists(out):
            os.remove(out)
        nms_sweep.launches = dwconv.launches = 0
        boxes, _, _ = detect.main(["--image", image, "--out", out, "--classesFile",
                                   files["classes"], "--device", "cuda"] + extra)
        launches = {"nms_sweep": nms_sweep.launches, "dwconv_bn_swish": dwconv.launches}
        check(os.path.getsize(out) > 0 and launches["nms_sweep"] >= 1,
              f"detect {name}: {out}, {launches}")
        if name == "efficientdet":
            check(launches["dwconv_bn_swish"] >= 16, f"detect {name}: {launches}")
        detected[name] = (len(boxes), launches)
    print(f"phase 20 serving leftovers on [{card}]: tmv_tpu_torch.serving.wsgi:application "
          f"built from TMV_* (bf16, cuda) on phase 18's checkpoint directory answered 6 "
          f"requests (p50 {served['YOLOv4 @608'][0]:.2f} ms, {served['YOLOv4 @608'][1]} "
          f"boxes, launches {served['YOLOv4 @608'][2]}) and on phase 13's D0 directory 4 "
          f"(p50 {served['D0 @512'][0]:.2f} ms, {served['D0 @512'][1]} boxes, launches "
          f"{served['D0 @512'][2]}); cli/detect.py wrote its image for YOLOv4 @608 "
          f"({detected['yolo'][0]} boxes, launches {detected['yolo'][1]}, the warm-up's "
          f"included) and D0 @512 ({detected['efficientdet'][0]} boxes, launches "
          f"{detected['efficientdet'][1]})", flush=True)
    nms = (sum(v[2]["nms_sweep"] for v in served.values())
           + sum(v[1]["nms_sweep"] for v in detected.values()))
    dw = (sum(v[2]["dwconv_bn_swish"] for v in served.values())
          + sum(v[1]["dwconv_bn_swish"] for v in detected.values()))
    return {"nms_sweep": nms, "dwconv_bn_swish": dw}


# ---------------------------------------------------------------- slice 8: FaceNet

def write_face_tree(root, people, images, seed, size=250):
    """``root/<name>/<name>_NNNN.jpg``: per person a seeded 10 x 10 colour pattern
    scaled to ``size``, each image that pattern shifted by up to 12 px with
    per-pixel noise; returns the names."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    names = [f"person_{seed}_{p:02d}" for p in range(people)]
    for name in names:
        os.makedirs(os.path.join(root, name), exist_ok=True)
        base = np.kron(rng.uniform(0, 255, (10, 10, 3)), np.ones((size // 10, size // 10, 1)))
        for i in range(images):
            dy, dx = rng.integers(-12, 13, 2)
            img = np.roll(base, (dy, dx), (0, 1)) + rng.normal(0, 18, base.shape)
            Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
                os.path.join(root, name, f"{name}_{i + 1:04d}.jpg"), quality=90)
    return names


def write_lfw_pairs(path, names, images, count, seed):
    """An LFW ``pairs.txt``: a header, then ``count`` pairs alternating same
    (``name i j``) and different (``a i b j``)."""
    rng = np.random.default_rng(seed)
    lines = [f"1\t{count}"]
    for k in range(count):
        if k % 2 == 0:
            i, j = rng.choice(np.arange(1, images + 1), 2, replace=False)
            lines.append(f"{names[rng.integers(len(names))]}\t{i}\t{j}")
        else:
            a, b = rng.choice(len(names), 2, replace=False)
            lines.append(f"{names[a]}\t{rng.integers(1, images + 1)}\t{names[b]}\t"
                         f"{rng.integers(1, images + 1)}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def facenet_setup(device, seed=0, optimizer="ADAM", remat=False, dropout_rate=0.2,
                  dtype=None):
    """A seeded FaceNet (IRv1 @160, embedding 512) in the CLI's train state
    (``optimizer`` at lr 1e-3, the shadow loss, the parameters' EMA 0.9999) and
    its train step."""
    import torch

    from tmv_tpu_torch.cli.train_facenet import make_optimizer
    from tmv_tpu_torch.core.train_state import TrainState, make_train_step
    from tmv_tpu_torch.models.facenet import FaceNetModel, make_triplet_train_step
    from tmv_tpu_torch.models.facenet.model import init_weights

    model = init_weights(FaceNetModel(FACE_EMBEDDING, device=device, remat=remat,
                                      dropout_rate=dropout_rate), seed)
    model = model.to(dtype=dtype or torch.float32, memory_format=torch.channels_last)
    state = TrainState.create(model, make_optimizer(optimizer, 1e-3, model.parameters()),
                              ema_decay=0.9999)
    loss_fn = make_triplet_train_step(0.2, torch.Generator(device=device).manual_seed(seed))
    return state, loss_fn, make_train_step(loss_fn, shadow_loss=True, ema_decay=0.9999)


def facenet_embedding_reading(backbone, images):
    """One backbone @160 in eval mode: the b30 forward by CUDA events, the card
    against the CPU on 4 images and the embedding norms."""
    import torch

    from tmv_tpu_torch.models.facenet import FaceNetModel, get_embeddings
    from tmv_tpu_torch.models.facenet.model import init_weights

    model = init_weights(FaceNetModel(FACE_EMBEDDING, backbone, device="cuda"), 0)
    model = model.to(memory_format=torch.channels_last).eval()
    x = torch.from_numpy(images[:FACE_BATCH]).cuda()
    with torch.inference_mode():
        for _ in range(3):
            model(x)
        ms = cuda_ms(lambda: model(x), 10)
    cpu = init_weights(FaceNetModel(FACE_EMBEDDING, backbone, device="cpu"), 0).eval()
    with torch.inference_mode():
        want = cpu(torch.from_numpy(images[:4])).numpy()
    got = get_embeddings(model, images[:4], 4)
    err = float(np.abs(got - want).max())
    norms = np.linalg.norm(get_embeddings(model, images[:FACE_BATCH], FACE_BATCH), axis=1)
    check(err <= 1e-4 * np.abs(want).max(),
          f"{backbone} @160: card vs CPU {err} (max |CPU| {np.abs(want).max()})")
    check(np.abs(norms - 1).max() <= 1e-5,
          f"{backbone} embedding norms {norms.min()}-{norms.max()}")
    params = sum(p.numel() for p in model.parameters())
    return model, {"ms": ms, "err": err, "max": float(np.abs(want).max()), "params": params,
                   "norm_err": float(np.abs(norms - 1).max())}


def mining_grid_case(seed):
    """A (45, 40, 512) grid of unit embeddings, each person a random centre plus
    twice its spread of noise; the last 10 images of 5 people padded."""
    rng = np.random.default_rng(seed)
    emb = (rng.normal(size=(MINING_PEOPLE, 1, FACE_EMBEDDING))
           + 2.0 * rng.normal(size=(MINING_PEOPLE, MINING_IMAGES, FACE_EMBEDDING)))
    emb = (emb / np.linalg.norm(emb, axis=-1, keepdims=True)).astype(np.float32)
    valid = np.ones((MINING_PEOPLE, MINING_IMAGES), bool)
    valid[:5, 30:] = False
    return emb, valid


def borderline_rows(grid, valid, alpha, margin=1e-5):
    """(n²,) bool on the card: the (anchor, positive) rows with a candidate
    negative whose float64 ``|neg − pos − α|`` or ``|neg − pos|`` is under
    ``margin``, where float32 rounding may decide the mining condition."""
    import torch

    p_num, i_num, d = grid.shape
    n = p_num * i_num
    flat = grid.reshape(n, d).double()
    sq = torch.sum(flat * flat, 1)
    dists = sq[:, None] + sq[None, :] - 2.0 * flat @ flat.T
    people = torch.arange(p_num, device=grid.device)
    pos = dists.reshape(p_num, i_num, p_num, i_num)[people, :, people][..., None]
    diff = dists.reshape(p_num, i_num, 1, n) - pos
    neg_ok = ((people.repeat_interleave(i_num)[None, :] != people[:, None])
              & valid.reshape(n)[None, :])
    close = ((diff - alpha).abs() < margin) | (diff.abs() < margin)
    block = torch.any(close & neg_ok[:, None, None, :], dim=-1)
    rows = torch.zeros((n, n), dtype=torch.bool, device=grid.device)
    rows.view(p_num, i_num, p_num, i_num)[people, :, people] = block
    return rows.reshape(-1)


def phase_facenet(card):
    """Phase 21: FaceNet. Embeddings of the four backbones @160, the mining at
    the CLI's defaults, cli/train_facenet.py on 12 x 8 synthetic people with the
    LFW flags, the step's numbers, an overfit, float32 against float64, a
    resume, the other optimizers, cli/validate_on_lfw.py and
    cli/facenet_distance.py. No hand-written kernel runs on this path."""
    import contextlib

    import torch

    from tmv_tpu_torch.cli import facenet_distance, train_facenet, validate_on_lfw
    from tmv_tpu_torch.core.checkpoint import CheckpointManager, load_weights
    from tmv_tpu_torch.kernels import dwconv, nms_sweep
    from tmv_tpu_torch.models.backbones.repvgg import get_repvgg_by_name, repvgg_convert_params
    from tmv_tpu_torch.models.facenet import FaceNetModel, get_embeddings, lfw
    from tmv_tpu_torch.models.facenet.model import draw_gumbel, init_weights, select_triplets

    check(not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32,
          "TF32 must stay off for the FaceNet comparisons")
    launches_before = (nms_sweep.launches, dwconv.launches)
    faces = os.path.join(WORK, "faces")
    lfw_dir = os.path.join(WORK, "lfw")
    shutil.rmtree(faces, ignore_errors=True)
    shutil.rmtree(lfw_dir, ignore_errors=True)
    write_face_tree(faces, FACE_PEOPLE, FACE_IMAGES, seed=21)
    lfw_names = write_face_tree(lfw_dir, LFW_PEOPLE, LFW_IMAGES, seed=22)
    pairs = write_lfw_pairs(os.path.join(WORK, "lfw_pairs.txt"), lfw_names, LFW_IMAGES,
                            LFW_PAIRS, seed=23)
    face_paths = sorted(os.path.join(faces, d, f) for d in sorted(os.listdir(faces))
                        for f in sorted(os.listdir(os.path.join(faces, d))))
    images = train_facenet.load_images(face_paths, FACE_IMAGE)

    # embeddings: IRv1 through get_embeddings at b30, then the other backbones
    readings = {}
    model, readings["InceptionResNetV1"] = facenet_embedding_reading("InceptionResNetV1", images)
    get_embeddings(model, images, FACE_BATCH)
    embed_ms = cuda_ms(lambda: get_embeddings(model, images, FACE_BATCH), 3)
    del model
    for backbone in ("InceptionResNetV2", "InceptionV4", "RepVGG"):
        model, readings[backbone] = facenet_embedding_reading(backbone, images)
        del model
    repvgg = init_weights(get_repvgg_by_name("RepVGG-B2g4", FACE_EMBEDDING, device="cuda"), 0)
    repvgg = repvgg.to(memory_format=torch.channels_last)
    x = torch.from_numpy(images[:FACE_BATCH]).cuda().permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    norms = [m for m in repvgg.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    with torch.no_grad():
        # the running statistics of one batch (momentum 1 for one train-mode forward):
        # at the identity statistics of the init the eval outputs reach ~1e4
        for m in norms:
            m.momentum = 1.0
        repvgg.train()(x)
        for m in norms:
            m.momentum = 0.01
        deploy = get_repvgg_by_name("RepVGG-B2g4", FACE_EMBEDDING, deploy=True, device="cuda")
        deploy.load_state_dict(repvgg_convert_params(repvgg), strict=True)
        x = x.flip(3)
        y_train = repvgg.eval()(x).cpu().numpy()
        y_deploy = deploy.eval().to(memory_format=torch.channels_last)(x).cpu().numpy()
    reparam_err = float(np.abs(y_deploy - y_train).max())
    check(np.allclose(y_deploy, y_train, rtol=1e-3, atol=1e-4),
          f"RepVGG-B2g4 deploy vs train on the card: {reparam_err}")
    del repvgg, deploy
    print(f"phase 21 FaceNet embeddings on [{card}]: eval f32 @{FACE_IMAGE}, embedding "
          f"{FACE_EMBEDDING}, seeded weights, TF32 off; b{FACE_BATCH} forward by CUDA events "
          "(10 after 3) " + ", ".join(
              f"{name} ({r['params']} parameters) {r['ms']:.2f} ms "
              f"({FACE_BATCH * 1e3 / r['ms']:.1f} images/s), card vs CPU on 4 images "
              f"{r['err']:.3g} (tolerance 1e-4 x {r['max']:.3g}), |norm - 1| <= "
              f"{r['norm_err']:.2g}" for name, r in readings.items())
          + f"; IRv1 get_embeddings of {len(images)} images at b{FACE_BATCH} (H2D and D2H "
          f"included) {embed_ms:.2f} ms ({len(images) * 1e3 / embed_ms:.1f} images/s); "
          f"RepVGG-B2g4 with one batch's BatchNorm statistics, deploy (repvgg_convert_params) "
          f"vs train on the card on the mirrored batch: max |diff| {reparam_err:.3g} of max "
          f"|y| {np.abs(y_train).max():.3g} (rtol 1e-3, atol 1e-4)", flush=True)

    # mining at the CLI's defaults
    grid_np, valid_np = mining_grid_case(21)
    grid, valid = torch.from_numpy(grid_np).cuda(), torch.from_numpy(valid_np).cuda()
    n = MINING_PEOPLE * MINING_IMAGES
    gen = torch.Generator(device="cuda").manual_seed(21)
    select_triplets(grid, valid, 0.2, generator=gen)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    mined, mined_valid = select_triplets(grid, valid, 0.2, generator=gen)
    torch.cuda.synchronize()
    mine_peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    mine_ms = cuda_ms(lambda: select_triplets(grid, valid, 0.2, generator=gen), 5)
    noise = draw_gumbel((MINING_PEOPLE, MINING_IMAGES, MINING_IMAGES, n),
                        torch.Generator().manual_seed(22))
    cpu_t, cpu_v = select_triplets(torch.from_numpy(grid_np), torch.from_numpy(valid_np), 0.2,
                                   gumbel=noise)
    card_t, card_v = (a.cpu() for a in select_triplets(grid, valid, 0.2, gumbel=noise.cuda()))
    border = borderline_rows(grid, valid, 0.2).cpu()
    clear = ~border
    check(torch.equal(cpu_v[clear], card_v[clear]), "mining: card and CPU valid masks differ "
          "away from the borderline pairs")
    keep = clear & cpu_v
    check(torch.equal(cpu_t[keep], card_t[keep]), "mining: card and CPU triplets differ")
    differ = int((cpu_v != card_v).sum() + ((cpu_t != card_t).any(1) & cpu_v & card_v).sum())
    check(int(cpu_v.sum()) > 0 and mine_peak < n ** 3 * 4 / 2**20 / 4,
          f"mining: {int(cpu_v.sum())} valid triplets, peak {mine_peak:.1f} MiB")
    print(f"phase 21 FaceNet mining on [{card}]: select_triplets at the CLI's defaults (P="
          f"{MINING_PEOPLE}, I={MINING_IMAGES}, n={n}, D={FACE_EMBEDDING}, 50 images padded), "
          f"per person block over (P, I, I, n) = {MINING_PEOPLE * MINING_IMAGES ** 2 * n:,} "
          f"elements: {mine_ms:.2f} ms (CUDA events, 5 calls after 2), peak above its inputs "
          f"{mine_peak:.1f} MiB (one (n, n, n) float32 tensor would take "
          f"{n ** 3 * 4 / 2**20:.0f} MiB); {int(mined_valid.sum())} of {n * n} rows valid with "
          f"the card's generator; with one CPU Gumbel draw, card = CPU: "
          f"{int(cpu_v.sum())} valid triplets, {int(border.sum())} borderline pairs "
          f"(|neg - pos - 0.2| or |neg - pos| under 1e-5 in float64), {differ} rows "
          "differing, all among them", flush=True)
    del grid, valid, noise

    # training through the CLI
    ckpt = os.path.join(WORK, "facenet_train")
    shutil.rmtree(ckpt, ignore_errors=True)
    argv = ["--filesPath", faces, "--peoplePerBatch", str(FACE_PEOPLE), "--imagesPerPerson",
            str(FACE_IMAGES), "--batchSize", str(FACE_BATCH), "--stepsPerEpoch", "1",
            "--epochs", "2", "--lfwDir", lfw_dir, "--lfwPairs", pairs, "--modelPath", ckpt,
            "--device", "cuda"]
    t0 = time.perf_counter()
    out = train_facenet.main(argv)
    wall = time.perf_counter() - t0
    check(out["step"] > 0 and all(np.isfinite(out["losses"])) and len(out["lfw"]) == 2,
          f"the FaceNet CLI: step {out['step']}, {len(out['lfw'])} LFW evaluations")
    saved = sorted(f for f in os.listdir(ckpt) if f.endswith(".pt"))
    check(f"{out['step']}.pt" in saved and len(saved) == 2, f"FaceNet checkpoints {saved}")
    parts = {k: statistics.median(o[k] for o in out["outer"]) * 1e3
             for k in ("load", "embed", "mine", "steps")}
    steps_per_outer = [o["train_steps"] for o in out["outer"]]
    lfw_acc = [float(r[0].mean()) for r in out["lfw"]]
    print(f"phase 21 FaceNet CLI on [{card}]: cli/train_facenet.py @{FACE_IMAGE} IRv1 "
          f"embedding {FACE_EMBEDDING} float32 Adam 1e-3, {FACE_PEOPLE} people x {FACE_IMAGES} "
          f"images, b{FACE_BATCH} (10 triplets a step), 2 epochs x 1 outer step: "
          f"{out['step']} steps ({steps_per_outer} per outer step, triplets "
          f"{[o['triplets'] for o in out['outer']]}) in {wall:.1f} s, loss "
          f"{out['losses'][0]:.4f} -> {out['losses'][-1]:.4f}; the outer step's host-clock "
          f"medians: load {parts['load']:.1f} ms, embed {parts['embed']:.1f} ms, mine "
          f"{parts['mine']:.1f} ms, steps {parts['steps']:.1f} ms; LFW accuracy on the "
          f"synthetic pairs (a smoke value) {lfw_acc}; checkpoints {saved}", flush=True)

    # the step's numbers on a fixed batch of 10 triplets
    person = np.repeat(np.arange(FACE_PEOPLE), FACE_IMAGES)
    anchors = np.array([p * FACE_IMAGES for p in range(10)])
    positives = anchors + 1
    negatives = (anchors + FACE_IMAGES * 3 + 2) % len(images)
    check(all(person[anchors] == person[positives]) and all(person[anchors] != person[negatives]),
          "the fixed triplet batch")
    batch = {k: torch.from_numpy(images[idx]).cuda()
             for k, idx in (("anchor", anchors), ("positive", positives),
                            ("negative", negatives))}
    numbers = {}
    for remat in (False, True):
        state, loss_fn, step = facenet_setup("cuda", remat=remat)
        for _ in range(3):
            step(state, batch)
        ms = cuda_ms(lambda: step(state, batch), 10)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        step(state, batch)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2**20
        loss, _ = loss_fn(state.model.train(), batch)      # what the forward keeps for the backward
        torch.cuda.synchronize()
        saved = (torch.cuda.memory_allocated() - base) / 2**20
        del loss
        numbers[remat] = (ms, peak, step_kernel_ms(lambda: step(state, batch), 3), saved)
        del state
    check(numbers[True][3] < numbers[False][3],
          f"remat did not lower what the FaceNet forward keeps: {numbers}")
    state, _, step = facenet_setup("cuda", seed=1)
    overfit = [float(step(state, batch)["raw_loss"]) for _ in range(OVERFIT_STEPS)]
    check(all(np.isfinite(overfit)) and (overfit[-1] <= overfit[0] / 5 or overfit[-1] == 0),
          f"FaceNet overfit: loss {overfit[0]:.4f} -> {overfit[-1]:.4f}")
    del state
    small = {k: v[:2].cpu() for k, v in batch.items()}
    results = {}
    for name, device, dtype in (("card", "cuda", torch.float32), ("cpu", "cpu", torch.float32),
                                ("cpu f64", "cpu", torch.float64)):
        state, loss_fn, _ = facenet_setup(device, seed=2, dropout_rate=0.0, dtype=dtype)
        model = state.model.train()
        loss, _ = loss_fn(model, {k: v.to(device, dtype) for k, v in small.items()})
        loss.backward()
        results[name] = (loss.item(), grads_of(model))
        del state, model
    (card_loss, card_g), (cpu_loss, cpu_g), (ref_loss, ref_g) = (
        results[k] for k in ("card", "cpu", "cpu f64"))
    loss_rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    card_err, cpu_err = rel_l2(card_g, ref_g), rel_l2(cpu_g, ref_g)
    check(loss_rel <= 1e-3, f"FaceNet f32 loss card {card_loss} vs CPU {cpu_loss}")
    check(card_err[0] <= 2 * cpu_err[0] + 1e-4 and card_err[1] <= 2 * cpu_err[1] + 1e-4,
          f"FaceNet f32 gradients: card vs float64 {card_err}, CPU vs float64 {cpu_err}")
    others = {}
    for name in ("ADAGRAD", "ADADELTA", "RMSPROP"):
        state, _, step = facenet_setup("cuda", seed=3, optimizer=name)
        dense = state.model.backbone.Dense_0.weight
        before = dense.detach().clone()
        loss = float(step(state, batch)["raw_loss"])
        moved = float((dense.detach() - before).abs().max())
        check(np.isfinite(loss) and moved > 0, f"FaceNet {name} step: loss {loss}, moved {moved}")
        others[name] = (loss, moved)
        del state
    print(f"phase 21 FaceNet step on [{card}]: IRv1 @{FACE_IMAGE} b{FACE_BATCH} (10 triplets) "
          f"float32 Adam, shadow loss, EMA (CUDA events, 10 steps after 3): "
          f"{numbers[False][0]:.2f} ms ({FACE_BATCH * 1e3 / numbers[False][0]:.1f} images/s), "
          f"kernels' device time per step (torch.profiler, 3 steps) {numbers[False][2]:.2f} ms "
          f"(busy {numbers[False][2] / numbers[False][0]:.2f}), peak of a warm step above "
          f"the resident state {numbers[False][1]:.1f} MiB, held by the forward for the "
          f"backward {numbers[False][3]:.1f} MiB; with --remat {numbers[True][0]:.2f} ms, "
          f"kernels {numbers[True][2]:.2f} ms, peak {numbers[True][1]:.1f} MiB, held "
          f"{numbers[True][3]:.1f} MiB; overfit of one batch, "
          f"{OVERFIT_STEPS} steps: loss {overfit[0]:.4f} -> {overfit[-1]:.4f} (required 5x or "
          f"0); f32 step on 2 triplets (TF32 off, dropout 0): loss card {card_loss:.6f}, CPU "
          f"{cpu_loss:.6f} (relative {loss_rel:.3g}), float64 {ref_loss:.6f}; gradients' "
          f"relative L2 error against float64 (overall, worst tensor): card {card_err[0]:.3g}, "
          f"{card_err[1]:.3g}; CPU float32 {cpu_err[0]:.3g}, {cpu_err[1]:.3g}; one step each, "
          "(raw loss, largest Dense_0 move): " + ", ".join(
              f"{k} ({v[0]:.4f}, {v[1]:.3g})" for k, v in others.items()), flush=True)

    # resume: the restored weights equal the checkpoint, the step count continues
    mgr = CheckpointManager(ckpt)
    last = torch.load(mgr.path(mgr.latest_step()), map_location="cpu", weights_only=True)
    state, _, _ = facenet_setup("cuda", seed=4)
    mgr.restore(state)
    mgr.close()
    check(state.step == out["step"] == last["step"], f"FaceNet restored step {state.step}")
    check(all(torch.equal(v.cpu(), last["model"][k]) for k, v in state.model.state_dict().items()),
          "FaceNet restored weights differ from the checkpoint")
    del state
    again = train_facenet.main(argv + ["--epochs", "1"])
    check(again["step"] > out["step"] and all(np.isfinite(again["losses"])),
          f"the FaceNet resume took the step from {out['step']} to {again['step']}")

    # the two inference CLIs on the trained directory
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        result = validate_on_lfw.main(["--lfwDir", lfw_dir, "--lfwPairs", pairs, "--modelPath",
                                       ckpt, "--imageSize", str(FACE_IMAGE), "--embeddingSize",
                                       str(FACE_EMBEDDING), "--batchSize", "32", "--device",
                                       "cuda"])
    lines = printed.getvalue().strip().splitlines()[-4:]
    check([line.split(":")[0] for line in lines] == ["Accuracy", "Validation rate",
                                                     "Area Under Curve (AUC)",
                                                     "Equal Error Rate (EER)"],
          f"validate_on_lfw printed {lines}")
    model = FaceNetModel(FACE_EMBEDDING, device="cuda")
    load_weights(model, ckpt)
    lfw_paths, issame = lfw.get_paths(lfw_dir, lfw.read_pairs(pairs))
    emb = get_embeddings(model, train_facenet.load_images(lfw_paths, FACE_IMAGE), 32)
    accuracy = lfw.evaluate(emb, issame)[2]
    check(np.array_equal(accuracy, result["accuracy"]),
          f"validate_on_lfw accuracy {result['accuracy']} vs recomputed {accuracy}")
    four = face_paths[:2] + face_paths[FACE_IMAGES:FACE_IMAGES + 2]
    with contextlib.redirect_stdout(io.StringIO()):
        matrix = facenet_distance.main(four + ["--modelPath", ckpt, "--imageSize",
                                               str(FACE_IMAGE), "--embeddingSize",
                                               str(FACE_EMBEDDING), "--device", "cuda"])
    emb4 = get_embeddings(model, train_facenet.load_images(four, FACE_IMAGE), 4)
    want = np.array([[float(np.sum((emb4[i] - emb4[j]) ** 2)) for j in range(4)]
                     for i in range(4)])
    check(np.array_equal(matrix, matrix.T) and not np.diag(matrix).any()
          and np.allclose(matrix, want, rtol=0, atol=1e-6),
          f"facenet_distance matrix {matrix} vs {want}")
    del model
    check((nms_sweep.launches, dwconv.launches) == launches_before,
          "the FaceNet path launched a hand-written kernel")
    print(f"phase 21 FaceNet inference CLIs on [{card}]: resumed from step {out['step']} to "
          f"{again['step']} (restored weights equal the checkpoint); validate_on_lfw on the "
          f"trained directory ({len(issame)} pairs): " + " | ".join(lines)
          + f" (= lfw.evaluate of recomputed embeddings); facenet_distance on 4 images: "
          f"symmetric, zero diagonal, = get_embeddings' squared distances (same person "
          f"{matrix[0, 1]:.4f}, {matrix[2, 3]:.4f}; different {matrix[0, 2]:.4f}); no "
          f"hand-written kernel launched", flush=True)
    return {"readings": readings, "mine_ms": mine_ms, "mine_peak": mine_peak,
            "numbers": numbers, "parts": parts, "card_err": card_err, "cpu_err": cpu_err}


# ---------------------------------------------------------------- MoCo and distillation

class CheckedSweep(SweepLog):
    """``SweepLog`` over the kernel that also runs the plain sweep on each call's
    inputs (on the card; it launches no kernel) and records whether the two
    whole masks agree."""

    def __init__(self):
        from tmv_tpu_torch.kernels.nms_sweep import greedy_sweep

        super().__init__(greedy_sweep)
        self.agree = []

    def __call__(self, boxes, eligible, *args):
        import torch

        from tmv_tpu_torch.kernels.nms_sweep import greedy_sweep_reference

        kept = super().__call__(boxes, eligible, *args)
        self.agree.append(bool(torch.equal(kept, greedy_sweep_reference(boxes, eligible, *args))))
        return kept


def moco_step_parts(state, batch, reps):
    """Medians over ``reps`` MoCo steps of each part by CUDA events: the key
    forward, the query forward and loss, the backward, SGD, the momentum blend
    and the enqueue (the step of ``models/moco.py``, split)."""
    import torch

    from tmv_tpu_torch.models.moco import flatten_normalize, momentum_update, push_queue
    from tmv_tpu_torch.ops.losses import moco_info_nce_loss

    names = ("key forward", "query forward + loss", "backward", "SGD", "momentum blend",
             "enqueue")
    parts = {k: [] for k in names}
    moco, model, optimizer = state.extra, state.model, state.optimizer
    for _ in range(reps):
        events = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
        events[0].record()
        moco.key_model.eval()
        with torch.no_grad():
            y_k = moco.key_model(batch["key"])
        events[1].record()
        model.train()
        optimizer.zero_grad(set_to_none=True)
        loss = moco_info_nce_loss(model(batch["query"]), y_k, moco.queue, 0.07)
        events[2].record()
        loss.backward()
        events[3].record()
        optimizer.step()
        events[4].record()
        momentum_update(moco.key_model, model, state.step, 0.999, 1000)
        events[5].record()
        moco.queue, moco.queue_ptr = push_queue(moco.queue, moco.queue_ptr,
                                                flatten_normalize(y_k))
        events[6].record()
        torch.cuda.synchronize()
        state.step += 1
        for k, (a, b) in zip(names, zip(events, events[1:])):
            parts[k].append(a.elapsed_time(b))
    return {k: statistics.median(v) for k, v in parts.items()}


def moco_f32_step(card, images):
    """One MoCo step in float32 (TF32 off) on the card and on the CPU, and in
    float64 on the CPU, from one query tower, one key tower (another seed), one
    queue (pointer 95 of 100, so the push wraps) and one two-crop batch at 416,
    B = 2, at step 500 of a 1000-step warm-up (decay 0.5). The card's loss
    within 1e-3 of the CPU's float32 loss; its gradients, blended key tower and
    written queue rows as close to float64 as the CPU's float32 are (within 2x,
    plus 1e-4). Then one push of the same keys into the same queue on the card
    and on the CPU: bit-equal."""
    import copy

    import torch

    from tmv_tpu_torch.cli.train_moco import build_tower, two_crop_batches
    from tmv_tpu_torch.core.train_state import TrainState
    from tmv_tpu_torch.models.moco import MocoState, make_moco_train_step, push_queue

    check(not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32,
          "TF32 must stay off for the float32 comparison")
    query0 = build_tower(MOCO_FILTERS, "cpu", False, seed=4)
    key0 = build_tower(MOCO_FILTERS, "cpu", False, seed=5)
    gen = torch.Generator().manual_seed(6)
    dim = MOCO_DIM
    queue0 = torch.nn.functional.normalize(torch.rand((MOCO_QUEUE, dim), generator=gen), dim=1)
    batch = next(two_crop_batches(images, 2, TRAIN_IMAGE, seed=7))
    results = {}
    for name, device, dtype in (("card", "cuda", torch.float32), ("cpu", "cpu", torch.float32),
                                ("cpu f64", "cpu", torch.float64)):
        model, key = (copy.deepcopy(m).to(device, dtype) for m in (query0, key0))
        model.dtype = key.dtype = dtype
        moco = MocoState(key, queue0.to(device, dtype), MOCO_QUEUE - 5)
        state = TrainState.create(model, torch.optim.SGD(model.parameters(), lr=1e-3,
                                                         momentum=0.9), extra=moco)
        state.step = 500
        metrics = make_moco_train_step()(state, {k: torch.from_numpy(v).to(device, dtype)
                                                 for k, v in batch.items()})
        results[name] = (float(metrics["loss"]), grads_of(model),
                         {n: t.detach().cpu().double()
                          for n, t in key.state_dict().items() if t.is_floating_point()},
                         moco.queue.detach().cpu().double())
        check(moco.queue_ptr == (MOCO_QUEUE - 5 + 2) % MOCO_QUEUE,
              f"queue pointer {moco.queue_ptr} after the push")
        del state, model, key, moco
    (card_loss, card_g, card_k, card_q), (cpu_loss, cpu_g, cpu_k, cpu_q), \
        (ref_loss, ref_g, ref_k, ref_q) = (results[k] for k in ("card", "cpu", "cpu f64"))
    loss_rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    card_err, cpu_err = rel_l2(card_g, ref_g), rel_l2(cpu_g, ref_g)
    card_key, cpu_key = rel_l2(card_k, ref_k), rel_l2(cpu_k, ref_k)
    rows = [(MOCO_QUEUE - 5 + i) % MOCO_QUEUE for i in range(2)]
    card_rows = float((card_q[rows] - ref_q[rows]).abs().max())
    cpu_rows = float((cpu_q[rows] - ref_q[rows]).abs().max())
    check(loss_rel <= 1e-3, f"MoCo f32 loss card {card_loss} vs CPU {cpu_loss}")
    check(card_err[0] <= 2 * cpu_err[0] + 1e-4 and card_err[1] <= 2 * cpu_err[1] + 1e-4,
          f"MoCo f32 gradients: card vs float64 {card_err}, CPU vs float64 {cpu_err}")
    check(card_key[0] <= 2 * cpu_key[0] + 1e-4 and card_key[1] <= 2 * cpu_key[1] + 1e-4,
          f"MoCo f32 key tower: card vs float64 {card_key}, CPU vs float64 {cpu_key}")
    check(card_rows <= 2 * cpu_rows + 1e-4,
          f"MoCo f32 queue rows: card {card_rows}, CPU {cpu_rows}")
    items = torch.nn.functional.normalize(torch.rand((TRAIN_BATCH, dim), generator=gen), dim=1)
    pushed = [push_queue(queue0.clone().to(device), MOCO_QUEUE - 3, items.to(device))
              for device in ("cuda", "cpu")]
    check(torch.equal(pushed[0][0].cpu(), pushed[1][0]) and pushed[0][1] == pushed[1][1] == 5,
          "the card's queue after a push differs from the CPU's")
    print(f"phase 22 MoCo f32 step card vs CPU (TF32 off, ResNetYoloV3 --outFilters "
          f"{MOCO_FILTERS} @{TRAIN_IMAGE} B=2, queue {MOCO_QUEUE} x {dim} from pointer "
          f"{MOCO_QUEUE - 5}, decay 0.5): InfoNCE loss card {card_loss:.6f}, CPU {cpu_loss:.6f} "
          f"(relative {loss_rel:.3g}, tolerance 1e-3), CPU float64 {ref_loss:.6f}; against the "
          f"CPU float64 step (relative L2 overall, worst tensor): gradients card "
          f"{card_err[0]:.3g}, {card_err[1]:.3g}, CPU float32 {cpu_err[0]:.3g}, "
          f"{cpu_err[1]:.3g}; blended key tower card {card_key[0]:.3g}, {card_key[1]:.3g}, CPU "
          f"float32 {cpu_key[0]:.3g}, {cpu_key[1]:.3g}; written queue rows max |diff| card "
          f"{card_rows:.3g}, CPU {cpu_rows:.3g} (tolerance: the card within 2x the CPU's + "
          f"1e-4); a push of 8 keys from pointer {MOCO_QUEUE - 3} (wrapping to 5): card queue "
          f"= CPU queue bit for bit on [{card}]", flush=True)
    return {"loss_rel": loss_rel, "card_err": card_err, "cpu_err": cpu_err}


def phase_moco(card, files):
    """Phase 22, MoCo: cli/train_moco.py pretrain at the CLI's defaults (@416,
    --outFilters 21, K = 100) at b8 with checkpoints, a resume, export_k and
    finetune; the step's parts, kernels and memory; float32 against float64.
    Neither hand-written kernel runs here."""
    import torch

    from tmv_tpu_torch.cli import train_moco
    from tmv_tpu_torch.core.checkpoint import CheckpointManager, read_weights
    from tmv_tpu_torch.kernels import dwconv, nms_sweep
    from tmv_tpu_torch.models.moco import make_moco_train_step

    nms_sweep.launches = dwconv.launches = 0
    moco_dir = os.path.join(WORK, "moco")
    export_dir = os.path.join(WORK, "moco_k")
    det_dir = os.path.join(WORK, "moco_det")
    for d in (moco_dir, export_dir, det_dir):
        shutil.rmtree(d, ignore_errors=True)
    base = ["--trainImagePath", files["images"], "--batchSize", str(TRAIN_BATCH), "--imageSize",
            str(TRAIN_IMAGE), "--queueSize", str(MOCO_QUEUE), "--outFilters", str(MOCO_FILTERS),
            "--modelPath", moco_dir, "--exportPath", export_dir, "--device", "cuda"]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    first = train_moco.main(["--mode", "pretrain", "--steps", str(MOCO_STEPS)] + base)
    wall = time.perf_counter() - t0
    cli_peak = torch.cuda.max_memory_allocated() / 2**30
    mgr = CheckpointManager(moco_dir)
    saved = torch.load(mgr.path(MOCO_STEPS), map_location="cpu", weights_only=True)
    check(first["step"] == MOCO_STEPS and first["feature_dim"] == MOCO_DIM,
          f"pretrain: step {first['step']}, feature dim {first['feature_dim']}")
    check(all(np.isfinite(first["losses"])), "a non-finite InfoNCE loss")
    ptr = MOCO_STEPS * TRAIN_BATCH % MOCO_QUEUE
    check(saved["step"] == MOCO_STEPS and saved["extra"]["queue_ptr"] == ptr
          and tuple(saved["extra"]["queue"].shape) == (MOCO_QUEUE, MOCO_DIM),
          "the pretrain checkpoint's step, pointer or queue")
    print(f"phase 22 MoCo pretrain CLI: ResNetYoloV3 --outFilters {MOCO_FILTERS} @{TRAIN_IMAGE} "
          f"b{TRAIN_BATCH} f32, queue {MOCO_QUEUE} x {first['feature_dim']} "
          f"({MOCO_QUEUE * MOCO_DIM * 4 / 1e6:.1f} MB), {MOCO_STEPS} steps in {wall:.1f} s (two "
          f"crops decoded and augmented on the host, a producer thread); InfoNCE loss first "
          f"{first['losses'][0]:.4f}, last {first['losses'][-1]:.4f}; checkpoint step "
          f"{saved['step']}, pointer {ptr}; peak memory {cli_peak:.2f} GiB on [{card}]",
          flush=True)

    again = train_moco.main(["--mode", "pretrain", "--steps", str(MOCO_STEPS + 2)] + base)
    last = torch.load(mgr.path(MOCO_STEPS + 2), map_location="cpu", weights_only=True)
    moved = sum(not torch.equal(last["extra"]["key_model"][k], v)
                for k, v in saved["extra"]["key_model"].items() if v.is_floating_point())
    written = [(ptr + i) % MOCO_QUEUE for i in range(2 * TRAIN_BATCH)]
    kept = [i for i in range(MOCO_QUEUE) if i not in written]
    check(again["step"] == MOCO_STEPS + 2 and len(again["losses"]) == 2
          and last["extra"]["queue_ptr"] == (ptr + 2 * TRAIN_BATCH) % MOCO_QUEUE
          and moved > 0
          and not torch.equal(last["extra"]["queue"][written], saved["extra"]["queue"][written])
          and torch.equal(last["extra"]["queue"][kept], saved["extra"]["queue"][kept]),
          "the resume did not continue the step, the pointer, the queue and the key tower")
    exported = train_moco.main(["--mode", "export_k"] + base)
    weights, step = read_weights(export_dir)
    check(exported["step"] == step == MOCO_STEPS + 2
          and all(torch.equal(weights[k], v) for k, v in last["extra"]["key_model"].items()),
          "export_k did not write the key tower")
    t0 = time.perf_counter()
    tuned = train_moco.main(["--mode", "finetune", "--steps", str(FINETUNE_STEPS),
                             "--trainData", files["labels"], "--classesFile", files["classes"],
                             "--anchorsFile", files["anchors"], "--modelPath", det_dir]
                            + base[:6] + ["--exportPath", export_dir, "--device", "cuda"])
    tune_wall = time.perf_counter() - t0
    heads = sorted(f"DarknetConv_{i}.Conv_0.{p}" for i in range(3) for p in ("weight", "bias"))
    check(sorted(tuned["skipped"]) == heads, f"finetune skipped {tuned['skipped']}")
    check(tuned["step"] == FINETUNE_STEPS and all(np.isfinite(tuned["losses"])),
          "finetune: steps or a non-finite loss")
    mgr.close()
    print(f"phase 22 MoCo resume, export and finetune: resumed at step {MOCO_STEPS} to "
          f"{again['step']} (pointer {ptr} -> {last['extra']['queue_ptr']}, the 16 written rows "
          f"changed and the other {len(kept)} kept, {moved} key-tower tensors moved); export_k "
          f"wrote the key tower at step {step} (= the checkpoint's, {len(weights)} tensors); "
          f"finetune grafted {len(tuned['copied'])} tensors and skipped exactly the 6 of the "
          f"output convs (80 classes: 255 filters against {MOCO_FILTERS}), "
          f"{FINETUNE_STEPS} CIoU + Adam + shadow-loss steps in {tune_wall:.1f} s, raw loss "
          f"{tuned['losses'][0]:.2f} -> {tuned['losses'][-1]:.2f} on [{card}]", flush=True)

    args = train_moco.parse_args(base)
    state, _ = train_moco.moco_train_state(args, torch.device("cuda"))
    crops = train_moco.two_crop_batches(files["images"], TRAIN_BATCH, TRAIN_IMAGE, seed=1)
    batch = train_moco.to_device(next(crops), "cuda")
    step = make_moco_train_step()
    for _ in range(3):
        step(state, batch)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reps = 10
    step_ms = cuda_ms(lambda: step(state, batch), reps)
    peak = (torch.cuda.max_memory_allocated() - resident) / 2**30
    parts = moco_step_parts(state, batch, 5)
    kernel_ms = step_kernel_ms(lambda: step(state, batch), 3)
    host = host_ms(lambda: next(crops), 3)
    print(f"phase 22 MoCo step on [{card}]: ResNetYoloV3 @{TRAIN_IMAGE} b{TRAIN_BATCH} f32 "
          f"(TF32 off), K = {MOCO_QUEUE}: {step_ms:.2f} ms per step by CUDA events over {reps} "
          f"steps after 3 of warm-up = {TRAIN_BATCH * 1e3 / step_ms:.1f} images/s; parts (CUDA "
          f"events, median of 5): " + ", ".join(f"{k} {v:.2f} ms" for k, v in parts.items())
          + "; kernels' device time per step (torch.profiler, 3 steps) "
          + (f"{kernel_ms:.2f} ms, busy share {kernel_ms / step_ms:.3f}" if kernel_ms else
             "not measured (the profiler traced no kernel)")
          + f"; peak above the resident state {peak:.2f} GiB (resident {resident / 2**30:.2f} "
          f"GiB: query, key, SGD momentum, queue); host two-crop batch (decode + augment, one "
          f"thread, median of 3) {host:.2f} ms", flush=True)
    del state, batch
    f32 = moco_f32_step(card, files["images"])
    check((nms_sweep.launches, dwconv.launches) == (0, 0),
          "the MoCo path launched a hand-written kernel")
    return {"step_ms": step_ms, "parts": parts, "kernel_ms": kernel_ms, "peak": peak,
            "f32": f32}


def labeler_readings(card, model, files, anchors, classes_num, reps=10):
    """The labeler's forward and post-process per b8 batch by CUDA events, and
    the student step (Adam, shadow loss) on one labelled batch with its kernels'
    device time."""
    import torch

    from tmv_tpu_torch.cli.train_distill import staged_images
    from tmv_tpu_torch.core.train_state import TrainState, make_train_step
    from tmv_tpu_torch.data.yolo_targets import make_yolo_targets
    from tmv_tpu_torch.models.detector_harness import make_yolo_loss_fn
    from tmv_tpu_torch.models.distill import draw_confidence, make_pseudo_label_fn
    from tmv_tpu_torch.models.moco import ResNetYoloV3
    from tmv_tpu_torch.ops.yolo import nms_boxes_batched

    image_wh = (TRAIN_IMAGE, TRAIN_IMAGE)
    paths = sorted(os.path.join(files["images"], f) for f in os.listdir(files["images"]))
    images = torch.from_numpy(staged_images(paths[:TRAIN_BATCH], image_wh)).cuda()
    conf = draw_confidence(TRAIN_BATCH, torch.Generator(device="cuda").manual_seed(0))
    model.eval()
    with torch.no_grad():
        heads = model(images)
        forward_ms = cuda_ms(lambda: model(images), reps)
        post_ms = cuda_ms(lambda: nms_boxes_batched(
            heads, anchors, image_wh, classes_num, confidence_thresh=conf, scores_thresh=0.3,
            iou_thresh=0.5, iou_type="iou", max_output_size=100), reps)
    boxes, ids, valid = make_pseudo_label_fn(model, anchors, image_wh, classes_num)(
        images, conf=conf)
    batch = {"image": images,
             "targets": make_yolo_targets(boxes, ids, valid, anchors, image_wh, classes_num)}
    student = ResNetYoloV3(3 * (5 + classes_num), device="cuda")
    student.load_state_dict(model.state_dict())
    student = student.to(memory_format=torch.channels_last)
    state = TrainState.create(student, torch.optim.Adam(student.parameters(), lr=1e-4))
    step = make_train_step(make_yolo_loss_fn(image_wh, anchors), shadow_loss=True)
    for _ in range(3):
        step(state, batch)
    step_ms = cuda_ms(lambda: step(state, batch), reps)
    kernel_ms = step_kernel_ms(lambda: step(state, batch), 3)
    del state, student
    return {"forward_ms": forward_ms, "post_ms": post_ms, "step_ms": step_ms,
            "kernel_ms": kernel_ms, "boxes": int(valid.sum())}


def phase_distill(card, files):
    """Phase 22, distillation: cli/train_distill.py train_teacher and promote
    (no kernel), then dump_labels and train_students with the seeded,
    box-row-scaled ResNetYoloV3 as the teacher, every pseudo-label sweep through
    the NMS kernel and held against the plain sweep. Returns the kernel's
    launches on this path."""
    import torch

    from tmv_tpu_torch.cli import train_distill
    from tmv_tpu_torch.core.checkpoint import read_weights
    from tmv_tpu_torch.data.loaders import load_anchors
    from tmv_tpu_torch.kernels import dwconv, nms_sweep
    from tmv_tpu_torch.kernels.nms_sweep import greedy_sweep, greedy_sweep_reference

    teacher_dir = os.path.join(WORK, "distill_teacher")
    promoted_dir = os.path.join(WORK, "distill_promoted")
    student_dir = os.path.join(WORK, "distill_student")
    for d in (teacher_dir, promoted_dir, student_dir):
        shutil.rmtree(d, ignore_errors=True)
    base = ["--trainImagePath", files["images"], "--classesFile", files["classes"],
            "--anchorsFile", files["anchors"], "--batchSize", str(TRAIN_BATCH), "--imageSize",
            str(TRAIN_IMAGE), "--device", "cuda"]
    nms_sweep.launches = dwconv.launches = 0
    t0 = time.perf_counter()
    teacher = train_distill.main(["--mode", "train_teacher", "--trainData", files["labels"],
                                  "--steps", str(TEACHER_STEPS), "--teacherPath", teacher_dir]
                                 + base)
    teacher_wall = time.perf_counter() - t0
    check(teacher["step"] == TEACHER_STEPS and all(np.isfinite(teacher["losses"])),
          "train_teacher: steps or a non-finite loss")
    train_distill.main(["--mode", "promote", "--studentPath", teacher_dir, "--teacherPath",
                        promoted_dir] + base)
    (promoted, p_step), (trained, _) = read_weights(promoted_dir), read_weights(teacher_dir)
    check(p_step == 0 and promoted.keys() == trained.keys()
          and all(torch.equal(promoted[k], v) for k, v in trained.items()),
          "promote did not copy the student into the teacher")
    check((nms_sweep.launches, dwconv.launches) == (0, 0),
          "the teacher's training launched a hand-written kernel")
    print(f"phase 22 distill train_teacher + promote: ResNetYoloV3 80 classes @{TRAIN_IMAGE} "
          f"b{TRAIN_BATCH} f32, {TEACHER_STEPS} steps in {teacher_wall:.1f} s, raw loss "
          f"{teacher['losses'][0]:.2f} -> {teacher['losses'][-1]:.2f}; promote: the teacher at "
          f"step 0 = the student's {len(trained)} tensors; no hand-written kernel launched on "
          f"[{card}]", flush=True)

    model, _, factor, box_max = seeded_v3("resnet", "cuda")
    seeded = os.path.join(WORK, "resnet_teacher_seed0.pt")
    torch.save({k: v.cpu() for k, v in model.state_dict().items()}, seeded)
    dump = base + ["--teacherPath", seeded, "--seed", "3"]
    outputs, logs, walls = {}, {}, {}
    for name, sweep in (("kernel", greedy_sweep), ("plain", greedy_sweep_reference)):
        logs[name] = SweepLog(sweep)
        nms_sweep.launches = 0
        t0 = time.perf_counter()
        with logs[name].patch():
            out = train_distill.main(["--mode", "dump_labels", "--labelsOut",
                                      os.path.join(WORK, f"pseudo_{name}.txt")] + dump)
        walls[name] = time.perf_counter() - t0
        outputs[name] = out
        if name == "kernel":
            dump_launches = nms_sweep.launches
        check(name == "kernel" or nms_sweep.launches == 0, "the plain sweep launched the kernel")
    with open(outputs["kernel"]["path"]) as f:
        kernel_lines = f.readlines()
    with open(outputs["plain"]["path"]) as f:
        plain_lines = f.readlines()
    batches = -(-TRAIN_SET // TRAIN_BATCH)
    check(kernel_lines == plain_lines, "the dumped labels differ between kernel and plain sweep")
    check(logs["kernel"].same_masks(logs["plain"]),
          "dump_labels: the sweeps' whole kept masks differ between kernel and plain")
    check(dump_launches == len(logs["kernel"].masks) == batches,
          f"{dump_launches} sweep launches for {batches} labeler calls")
    swept, eligible = logs["kernel"].kept(), logs["kernel"].eligibles()
    check(all(k < e for k, e in zip(swept, eligible)),
          f"a dump sweep suppressed nothing (kept {swept} of {eligible})")
    per_batch = [sum(line.count("|") - 1 for line in kernel_lines[i:i + TRAIN_BATCH])
                 for i in range(0, len(kernel_lines), TRAIN_BATCH)]
    check(len(kernel_lines) == TRAIN_SET and min(per_batch) >= 1,
          f"a pseudo-label batch without a box: boxes per batch {per_batch}")
    print(f"phase 22 distill dump_labels: the seeded ResNetYoloV3 (80 classes, box rows x "
          f"{factor:g}; largest box logit {box_max:.3g} unscaled) labels the {TRAIN_SET} images "
          f"in {batches} b{TRAIN_BATCH} batches: {dump_launches} sweep launches (one per "
          f"labeler call), the file identical with the plain sweep's ({outputs['kernel']['boxes']}"
          f" boxes), the whole kept masks identical; per image the sweep kept "
          f"{min(swept)}-{max(swept)} of {min(eligible)}-{max(eligible)} eligible; boxes per "
          f"batch {per_batch}; {TRAIN_SET / walls['kernel']:.1f} images/s through the CLI "
          f"(host clock: decode, resize, label, write) with the kernel, "
          f"{TRAIN_SET / walls['plain']:.1f} with the plain sweep on [{card}]", flush=True)

    log = CheckedSweep()
    nms_sweep.launches = 0
    t0 = time.perf_counter()
    with log.patch():
        students = train_distill.main(["--mode", "train_students", "--steps", str(STUDENT_STEPS),
                                       "--teacherPath", seeded, "--studentPath", student_dir]
                                      + base)
    student_wall = time.perf_counter() - t0
    student_launches = nms_sweep.launches
    kept = [sum(m.sum(1)) for m in log.masks]
    check(students["step"] == STUDENT_STEPS and all(np.isfinite(students["losses"])),
          "train_students: steps or a non-finite loss")
    check(student_launches == len(log.masks) == STUDENT_STEPS and all(log.agree),
          f"train_students: {student_launches} launches for {STUDENT_STEPS} labeler calls, "
          f"masks equal to the plain sweep's {log.agree}")
    check(min(kept) >= 1 and all(k < e for k, e in zip(log.kept(), log.eligibles())),
          f"train_students: a batch without a pseudo-label or a sweep without a suppression")
    numbers = labeler_readings(card, model, files, load_anchors(files["anchors"]), 80)
    print(f"phase 22 distill train_students: {STUDENT_STEPS} steps in {student_wall:.1f} s (host "
          f"clock, each with its b{TRAIN_BATCH} decode, labeler call and targets on the card, and "
          f"the plain sweep of the check), {student_launches} sweep launches, every whole mask = "
          f"the plain sweep's, kept per batch {min(kept)}-{max(kept)}; raw loss "
          f"{students['losses'][0]:.2f} -> {students['losses'][-1]:.2f}. Labeler per b"
          f"{TRAIN_BATCH} batch (CUDA events, mean of 10): forward {numbers['forward_ms']:.2f} "
          f"ms, post-process (decode, top-k, class-aware IoU sweep, gathers) "
          f"{numbers['post_ms']:.2f} ms; student step (Adam, shadow loss) "
          f"{numbers['step_ms']:.2f} ms, kernels "
          + (f"{numbers['kernel_ms']:.2f} ms (busy {numbers['kernel_ms'] / numbers['step_ms']:.3f})"
             if numbers["kernel_ms"] else "not measured") + f" on [{card}]", flush=True)
    del model
    return {"launches": dump_launches + student_launches, "dump": dump_launches,
            "students": student_launches, "numbers": numbers}


# ---------------------------------------------------------------- int8 serving

class Int8Calls:
    """Within the block, every ``int8_conv`` / ``int8_dwconv`` call made by
    ``quant/static.py`` and ``quant/dynamic.py`` is kept (its arguments, tensors
    included) and then run as it would be; with ``distinct``, only the first call
    of each ``call_key``, so that a long run keeps a bounded set of tensors."""

    def __init__(self, distinct=False):
        self.calls, self.distinct, self._seen = [], distinct, set()

    def __enter__(self):
        from tmv_tpu_torch.kernels import int8_conv as kernels

        def keep(name, fn):
            def call(*args, **kwargs):
                key = call_key(name, int8_call_args(name, args, kwargs))
                if not self.distinct or key not in self._seen:
                    self._seen.add(key)
                    self.calls.append((name, args, kwargs))
                return fn(*args, **kwargs)
            return call

        self._patches = [
            mock.patch("tmv_tpu_torch.quant.static.int8_conv", keep("int8_conv", kernels.int8_conv)),
            mock.patch("tmv_tpu_torch.quant.static.int8_dwconv",
                       keep("int8_dwconv", kernels.int8_dwconv)),
            mock.patch("tmv_tpu_torch.quant.dynamic.int8_conv",
                       keep("int8_conv", kernels.int8_conv))]
        for p in self._patches:
            p.start()
        return self

    def __exit__(self, *exc):
        for p in self._patches:
            p.stop()


def int8_call_args(name, args, kwargs):
    """(x, kernel_q, in_absmax, deq, offset, kernel size, stride, pads, out dtype) of a
    kept call."""
    names = (("x", "kernel_q", "in_absmax", "deq", "offset", "kernel_size", "stride", "pads")
             if name == "int8_conv" else
             ("x", "kernel_q", "in_absmax", "deq", "offset", "k", "stride", "pads"))
    bound = dict(zip(names, args), **kwargs)
    ks = bound["kernel_size"] if name == "int8_conv" else (bound["k"], bound["k"])
    import torch

    return (bound["x"], bound["kernel_q"], bound["in_absmax"], bound["deq"], bound.get("offset"),
            tuple(ks), bound.get("stride", 1), tuple(bound.get("pads", (0, 0, 0, 0))),
            bound.get("out_dtype", torch.float32))


def int8_run(name, x, kq, absmax, deq, offset, ks, stride, pads, out_dtype=None, plain=False,
             acc=False):
    import torch

    from tmv_tpu_torch.kernels import int8_conv as kernels

    out_dtype = out_dtype or torch.float32
    if name == "int8_conv":
        fn = kernels.int8_conv_reference if plain else kernels.int8_conv
        return fn(x, kq, absmax, deq, offset, ks, stride, pads, return_acc=acc,
                  out_dtype=out_dtype)
    fn = kernels.int8_dwconv_reference if plain else kernels.int8_dwconv
    return fn(x, kq, absmax, deq, offset, ks[0], stride, pads, return_acc=acc,
              out_dtype=out_dtype)


def int8_bound_ms(name, x, kq, ks, stride, pads, out_dtype):
    """Least time of one int8 conv: the larger of its bytes (the activation read
    once, int8 weights, the per-channel vectors, the output written once in its
    type) over the HBM rate and its operations (2 per int8 product over the real K,
    not the padded one) over the int8 tensor-core rate."""
    import torch

    b, c, h, w = x.shape
    top, left, bottom, right = pads
    h_out = (h + top + bottom - ks[0]) // stride + 1
    w_out = (w + left + right - ks[1]) // stride + 1
    cout = kq.shape[0] if name == "int8_conv" else c
    k = ks[0] * ks[1] * (c if name == "int8_conv" else 1)
    out_bytes = 2 if out_dtype == torch.bfloat16 else 4
    nbytes = (x.numel() * x.element_size() + cout * k + 3 * 4 * max(cout, c)
              + b * h_out * w_out * cout * out_bytes)
    ops = 2 * b * h_out * w_out * cout * k
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT8_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations", ops


def library_int8(name, x, kq, absmax, deq, offset, ks, stride, pads, out_dtype):
    """The library route for the same function, which the port never calls: the
    quantize in torch ops, then for a dense conv an int8 im2col (padded, strided
    slices stacked) and ``torch._int_mm`` (cuBLASLt's int8 GEMM, K and N padded to
    multiples of 8), for a depthwise conv cuDNN's grouped ``F.conv2d`` on the int8
    values held in float32 (exact: |acc| < 2^24, TF32 off); then the dequant."""
    import torch
    import torch.nn.functional as F

    from tmv_tpu_torch.kernels.int8_conv import quantize_reference, unpack_dense

    top, left, bottom, right = pads
    b, c, h, w = x.shape
    if name == "int8_conv":
        kh, kw = ks
        weight = unpack_dense(kq, kh, kw, c).reshape(kh * kw * c, -1)     # (K, N)
        k_real, n = weight.shape
        k_pad, n_pad = max(32, -(-k_real // 8) * 8), -(-n // 8) * 8
        weight = F.pad(weight, (0, n_pad - n, 0, k_pad - k_real)).contiguous()

        def call():
            xq = quantize_reference(x, absmax).permute(0, 2, 3, 1)        # NHWC int8
            xq = F.pad(xq, (0, 0, left, right, top, bottom))
            h_out = (h + top + bottom - kh) // stride + 1
            w_out = (w + left + right - kw) // stride + 1
            cols = torch.cat([xq[:, dy:dy + (h_out - 1) * stride + 1:stride,
                                 dx:dx + (w_out - 1) * stride + 1:stride]
                              for dy in range(kh) for dx in range(kw)], dim=-1)
            cols = F.pad(cols.reshape(-1, k_real), (0, k_pad - k_real))
            acc = torch._int_mm(cols, weight)[:, :n]
            y = acc.float() * deq
            if offset is not None:
                y = y + offset
            return y.to(out_dtype).reshape(b, h_out, w_out, n).permute(0, 3, 1, 2)
        return call
    k = ks[0]
    weight = kq.t().reshape(c, 1, k, k).float()

    def call():
        xq = quantize_reference(x, absmax).float()
        acc = F.conv2d(F.pad(xq, (left, right, top, bottom)), weight, stride=stride, groups=c)
        y = acc * deq.view(1, -1, 1, 1)
        return (y if offset is None else y + offset.view(1, -1, 1, 1)).to(out_dtype)
    return call


def cudnn_bf16(name, x, kq, ks, stride, pads):
    """The float route the int8 conv replaces: cuDNN's bf16 ``F.conv2d`` of the
    same shapes (random bf16 weights), on the activation in bf16."""
    import torch
    import torch.nn.functional as F

    b, c, h, w = x.shape
    top, left, bottom, right = pads
    xb = x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    cout, groups = (kq.shape[0], 1) if name == "int8_conv" else (c, c)
    weight = torch.randn((cout, c // groups) + tuple(ks), device=x.device, dtype=torch.bfloat16)
    weight = weight.contiguous(memory_format=torch.channels_last)
    if (top, left) == (bottom, right):
        return lambda: F.conv2d(xb, weight, None, stride, (top, left), groups=groups)
    return lambda: F.conv2d(F.pad(xb, (left, right, top, bottom)), weight, None, stride,
                            groups=groups)


def check_int8_call(name, x, kq, absmax, deq, offset, ks, stride, pads, out_dtype):
    """The kernel against its plain version on one call's inputs: the int32
    accumulators identical, the float32 outputs within 1e-6·max|plain|, and in
    the call's own output type (bf16: the cast fused) within one bf16 step of the
    plain value plus 1e-6·max|plain| → max |diff| of the float32 outputs."""
    import torch

    args = (name, x, kq, absmax, deq, offset, ks, stride, pads)
    acc = int8_run(*args, acc=True)
    want_acc = int8_run(*args, plain=True, acc=True)
    y = int8_run(*args)
    want = int8_run(*args, plain=True)
    torch.cuda.synchronize()
    what = (f"{name} {tuple(x.shape)} {str(x.dtype)[6:]} k={ks} s={stride} pads={pads} "
            f"{'per-channel' if absmax.dim() else 'per-tensor'}")
    check(acc.shape == want_acc.shape and torch.equal(acc, want_acc),
          f"{what}: int32 accumulator differs from the plain version's")
    check(y.dtype == torch.float32 and y.is_contiguous(memory_format=torch.channels_last),
          f"{what}: output layout")
    err = float((y - want).abs().max())
    check(err <= 1e-6 * float(want.abs().max()), f"{what}: max |diff| {err:.3g}")
    if out_dtype == torch.bfloat16:
        got = int8_run(*args, out_dtype=out_dtype)
        torch.cuda.synchronize()
        check(got.dtype == torch.bfloat16 and within_one_bf16_step(got, want),
              f"{what}: bf16 output beyond one bf16 step of the plain value")
    return err


def int8_edge_calls(gen):
    """Edge cases of both kernels on the card: Cin = 3 (one 16-channel chunk a tap),
    Cout 32, 64 and 255 and ragged Cout and K (16, 24, 40, 48, 80), M not a multiple of
    the GEMM's 128-row tile, odd H and W at stride 2 under Darknet's and TF-SAME pads,
    H = W = 1, k = 5 depthwise at both strides, in f32 and bf16, per-tensor and
    per-channel."""
    import torch

    from tmv_tpu_torch.kernels.int8_conv import pack_dense

    dense = [(1, 17, 13, 3, 32, 3, 1, (1, 1, 1, 1)), (2, 15, 11, 3, 24, 3, 2, (0, 0, 1, 1)),
             (2, 9, 7, 16, 40, 1, 1, (0, 0, 0, 0)), (1, 13, 13, 24, 112, 1, 1, (0, 0, 0, 0)),
             (3, 33, 35, 40, 24, 3, 2, (1, 1, 0, 0)), (1, 1, 1, 24, 112, 3, 1, (1, 1, 1, 1)),
             (1, 1, 1, 64, 8, 3, 2, (1, 1, 1, 1)), (2, 19, 21, 64, 130, 3, 1, (1, 1, 1, 1)),
             # the GEMM's tile edges: Cout 32 / 64 / 255 (a ragged 128-wide tile), Cin 3
             # at stride 2 on odd sizes, M not a multiple of the 128-row tile, ragged K
             (1, 21, 17, 3, 32, 3, 2, (1, 1, 0, 0)), (2, 23, 19, 32, 64, 3, 1, (1, 1, 1, 1)),
             (2, 20, 20, 256, 255, 1, 1, (0, 0, 0, 0)), (1, 11, 9, 80, 255, 3, 2, (1, 1, 0, 0)),
             (3, 13, 11, 48, 96, 3, 1, (1, 1, 1, 1))]
    depthwise = [(2, 17, 15, 32, 3, 1, (1, 1, 1, 1)), (1, 33, 31, 6, 5, 2, (1, 1, 2, 2)),
                 (1, 1, 1, 240, 5, 1, (2, 2, 2, 2)), (2, 9, 10, 24, 3, 2, (0, 0, 1, 1)),
                 # the halo tile's edges: k = 5 at both strides on odd sizes, C past a
                 # 32-channel chunk
                 (2, 19, 17, 40, 5, 1, (2, 2, 2, 2)), (1, 23, 21, 144, 5, 2, (1, 1, 2, 2)),
                 (2, 15, 13, 72, 3, 2, (0, 0, 1, 1))]
    for dtype in (torch.float32, torch.bfloat16):
        for per_channel in (False, True):
            for b, h, w, cin, cout, k, s, pads in dense:
                x = torch.randn((b, h, w, cin), generator=gen, device="cuda").permute(0, 3, 1, 2)
                x = (x * 2).to(dtype).contiguous(memory_format=torch.channels_last)
                kq = pack_dense(torch.randint(-127, 128, (k, k, cin, cout), generator=gen,
                                              device="cuda").to(torch.int8))
                yield ("int8_conv", x, kq, int8_absmax(gen, cin, per_channel),
                       torch.rand((cout,), generator=gen, device="cuda") * 1e-3,
                       torch.randn((cout,), generator=gen, device="cuda"), (k, k), s, pads,
                       dtype)
            for b, h, w, c, k, s, pads in depthwise:
                x = torch.randn((b, h, w, c), generator=gen, device="cuda").permute(0, 3, 1, 2)
                x = (x * 2).to(dtype).contiguous(memory_format=torch.channels_last)
                kq = torch.randint(-127, 128, (k * k, c), generator=gen, device="cuda").to(torch.int8)
                yield ("int8_dwconv", x, kq, int8_absmax(gen, c, per_channel),
                       torch.rand((c,), generator=gen, device="cuda") * 1e-3, None, (k, k), s, pads,
                       dtype)


def int8_absmax(gen, c, per_channel):
    import torch

    if per_channel:
        return torch.rand((c,), generator=gen, device="cuda") * 4 + 0.5
    return torch.rand((), generator=gen, device="cuda") * 4 + 0.5


def call_key(name, call):
    """(kernel, shapes, dtype, pads, scale kind, output type) of a call's arguments."""
    x, kq, absmax, _, _, ks, stride, pads, out_dtype = call
    return (name, tuple(x.shape), x.dtype, tuple(kq.shape), ks, stride, pads, absmax.dim(),
            out_dtype)


def distinct_calls(calls):
    """The kept calls with one of each ``call_key``, as check_int8_call's cases."""
    seen, out = set(), []
    for name, args, kwargs in calls:
        call = int8_call_args(name, args, kwargs)
        key = call_key(name, call)
        if key not in seen:
            seen.add(key)
            out.append((name,) + call)
    return out


def int8_calibration_set(count=16):
    """``count`` seeded scene JPEGs of mixed sizes for ``--int8Static``."""
    root = os.path.join(WORK, "int8_calib")
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(23)
    sizes = [(480, 640), (720, 1280), (640, 640), (375, 500)]
    for i in range(count):
        write_atomic(os.path.join(root, f"scene_{i:02d}.jpg"),
                     scene_jpeg(rng, *sizes[i % len(sizes)]))
    return root


def box_agreement(want, got):
    """Share of ``want``'s kept boxes that ``got`` keeps too: a box of the same
    class at IoU ≥ 0.5, per image, pooled."""
    from tmv_tpu_torch.ops.iou import iou_xyxy

    import torch

    matched = total = 0
    for wb, wi, wv, gb, gi, gv in zip(want[0], want[1], want[3], got[0], got[1], got[3]):
        wb, wi, gb, gi = wb[wv], wi[wv], gb[gv], gi[gv]
        total += len(wb)
        for box, cls in zip(wb, wi):
            same = gb[gi == cls]
            if len(same) and float(iou_xyxy(torch.from_numpy(box[None]),
                                            torch.from_numpy(same)).max()) >= 0.5:
                matched += 1
    return matched / max(total, 1), total


def forward_readings(model, quant, batch=16):
    """(b1 forward p50 ms, each of 30 forwards between CUDA events; b``batch``
    forward images/s by CUDA events over 10 back-to-back forwards), after warm-up."""
    import torch

    from tmv_tpu_torch.quant import quantized

    rng = np.random.default_rng(29)
    one = torch.from_numpy(rng.uniform(0, 1, (1, IMAGE, IMAGE, 3)).astype(np.float32)).cuda()
    many = torch.from_numpy(rng.uniform(0, 1, (batch, IMAGE, IMAGE, 3)).astype(np.float32)).cuda()
    with torch.inference_mode(), quantized(quant):
        for _ in range(3):
            model(one), model(many)
        samples = []
        for _ in range(30):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            model(one)
            end.record()
            torch.cuda.synchronize()
            samples.append(start.elapsed_time(end))
        ms = cuda_ms(lambda: model(many), 10)
    return statistics.median(samples), batch * 1000 / ms


def sum_int8_times(card, calls, label):
    """Kernel, plain, library and cuDNN bf16 milliseconds and the bound, summed
    over one forward's kept calls; each call's kernel is first held against its
    plain version (check_int8_call) → also the largest |kernel - plain|."""
    import torch

    total = dict(ms=0.0, device_ms=0.0, plain_ms=0.0, library_ms=0.0, cudnn_ms=0.0,
                 bound_ms=0.0, ops=0, by={"bytes": 0.0, "operations": 0.0},
                 launches=len(calls), max_err=0.0)
    each = []
    for name, args, kwargs in calls:
        call = int8_call_args(name, args, kwargs)
        x, kq, absmax, deq, offset, ks, stride, pads, out_dtype = call
        total["max_err"] = max(total["max_err"], check_int8_call(name, *call))
        kernel = lambda: int8_run(name, *call)  # noqa: E731
        plain = lambda: int8_run(name, *call, plain=True)  # noqa: E731
        library = library_int8(name, *call)
        lib_out, ref = library(), plain()
        check(torch.equal(lib_out.float(), ref.float()) or within_one_bf16_step(lib_out, ref),
              f"the library route computes another function at {tuple(x.shape)} {ks}")
        cudnn = cudnn_bf16(name, x, kq, ks, stride, pads)
        kernel(), cudnn()
        k_ms, p_ms, _ = turns(plain, kernel, 1, 5)
        bound, by, ops = int8_bound_ms(name, x, kq, ks, stride, pads, out_dtype)
        cudnn_ms = cuda_ms(cudnn, 5)
        for key, v in (("ms", k_ms), ("device_ms", graph_ms(kernel, reps=5)), ("plain_ms", p_ms),
                       ("library_ms", cuda_ms(library, 2)), ("cudnn_ms", cudnn_ms),
                       ("bound_ms", bound), ("ops", ops)):
            total[key] += v
        each.append((k_ms, tuple(x.shape), kq.shape[0] if name == "int8_conv" else x.shape[1],
                     ks, stride, cudnn_ms, bound, by))
        total["by"][by] += bound
        del lib_out, ref
    print(f"phase 23 {label} on [{card}]: {total['launches']} launches, kernel "
          f"{total['ms']:.4f} ms ({total['ops'] / total['ms'] / 1e9:.1f} TOP/s; device time by "
          f"CUDA-graph replay, without the host's work per call, {total['device_ms']:.4f} ms), plain "
          f"{total['plain_ms']:.4f} ms, library (quantize + int8 im2col + torch._int_mm + dequant; "
          f"cuDNN f32 grouped conv for depthwise) {total['library_ms']:.4f} ms, cuDNN bf16 "
          f"{total['cudnn_ms']:.4f} ms, bound {total['bound_ms']:.4f} ms (kernel at "
          f"{total['bound_ms'] / total['ms']:.1%} of the bound); every launch's int32 "
          f"accumulator identical to the plain version's, outputs within 1e-6·max|plain| "
          f"(max |kernel - plain| {total['max_err']:.3g})", flush=True)
    for k_ms, shape, cout, ks, stride, cudnn_ms, bound, by in sorted(each, reverse=True)[:5]:
        print(f"phase 23 {label}, a slowest launch: x {shape} (B, C, H, W) -> {cout} channels "
              f"k={ks} s={stride}: kernel {k_ms:.4f} ms, cuDNN bf16 {cudnn_ms:.4f} ms, bound "
              f"{bound:.4f} ms by {by}", flush=True)
    return total


def quantize_share(card, calls, label):
    """int8_conv's first launch, the quantize pass, alone over a forward's int8_conv
    calls: each held to its plain version, its device ms summed (CUDA-graph replay),
    and the host's cost of one such launch (the enqueue of 200 launches of the first
    call on the host clock) → (ms, host µs)."""
    import torch

    from tmv_tpu_torch.kernels import int8_conv as kernels

    total, first = 0.0, None
    for name, args, kwargs in calls:
        if name != "int8_conv":
            continue
        x, _, absmax = int8_call_args(name, args, kwargs)[:3]
        check(torch.equal(kernels.quantize_padded(x, absmax),
                          kernels.quantize_padded_reference(x, absmax)),
              f"the quantize pass differs from its plain version at {tuple(x.shape)}")
        total += graph_ms(lambda: kernels.quantize_padded(x, absmax), reps=5)
        first = first or (x, absmax)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        kernels.quantize_padded(*first)
    host_us = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    print(f"phase 23 {label} on [{card}]: the quantize pass of the int8_conv calls, "
          f"{total:.4f} ms of device time summed (each equal to its plain version); one "
          f"launch costs the host {host_us:.1f} us to enqueue", flush=True)
    return total, host_us


def phase_int8(card, weights, files, ckpt, d0_ckpt):
    """Phase 23: the int8 kernels against their plain versions on the card, at
    every distinct call of the paths below; YOLOv4 @640 served in static
    (per-channel) int8 at b1 and b16 and dynamic int8 at b1, beside bf16; the int8
    eval CLI for YOLOv4 and D0; the kernels' times over one forward."""
    import torch

    from tmv_tpu_torch.cli import eval_map, serve
    from tmv_tpu_torch.kernels import dwconv, int8_conv, nms_sweep
    from tmv_tpu_torch.models.detector_harness import make_yolo_predict_batched
    from tmv_tpu_torch.models.yolo_v4 import COCO_ANCHORS
    from tmv_tpu_torch.quant import calibrate_model, prepare_static_int8, quantized

    classes_file, anchors_file = write_inputs(COCO_CLASSES, COCO_ANCHORS)
    calib = int8_calibration_set()
    serve_base = ["--modelPath", weights, "--classesFile", classes_file, "--anchorsFile",
                  anchors_file, "--imageSize", str(IMAGE), "--bf16", "--device", "cuda"]
    launches = {"int8_conv": 0, "int8_dwconv": 0}

    # 1. YOLOv4 @640 served in bf16, static per-channel and dynamic int8 at b1 (one
    #    request at a time); in bf16 and static per-channel at b16, from 16 clients at once
    served, served_calls = {}, []
    static = ["--int8Static", calib, "--int8PerChannel"]
    for label, extra in (("bf16 b1", []), ("static b1", static), ("dynamic b1", ["--int8"]),
                         ("bf16 b16", ["--batch", "16"]),
                         ("static b16", static + ["--batch", "16"])):
        app, service, model = serve.build_app(serve.parse_args(serve_base + extra))
        try:
            with Int8Calls(distinct=True) as kept_calls:
                if service.batcher is None:
                    latencies, _, boxes, counts = drive_server(app, SERVED_B1_REQUESTS, 31)
                    forwards, wall = len(latencies), None
                else:
                    wall, latencies, boxes, counts = drive_server_concurrent(
                        app, SERVED_B16_REQUESTS, 16, 37)
                    forwards = service.batcher.dispatch_count
        finally:
            if service.batcher is not None:
                service.batcher.close()
        per_forward = 0 if label.startswith("bf16") else 107
        check(counts["int8_conv"] == per_forward * forwards,
              f"{label}: {counts['int8_conv']} int8_conv launches for {forwards} forwards")
        check(counts["nms_sweep"] >= forwards, f"{label}: NMS launches")
        if wall:
            check(forwards < len(latencies),
                  f"{label}: {forwards} forwards for {len(latencies)} concurrent requests")
        launches["int8_conv"] += counts["int8_conv"]
        served_calls += distinct_calls(kept_calls.calls)
        served[label] = (statistics.median(latencies), len(latencies) / wall if wall else None)
        rate = (f", {served[label][1]:.1f} images/s in {forwards} forwards (mean batch "
                f"{len(latencies) / forwards:.1f})" if wall else "")
        print(f"phase 23 serving YOLOv4 @{IMAGE} {label}: {len(latencies)} requests -> HTTP 200, "
              f"{boxes} boxes, int8_conv.launches {counts['int8_conv']} ({per_forward} per "
              f"forward), served p50 {served[label][0]:.2f} ms{rate} on [{card}]", flush=True)
        if label == "static b16":
            static_model = model
        del app, service, model, kept_calls
    model = static_model
    check(model.ConvBN_0.in_absmax.shape == (3,), "the served model is not per-channel")

    # 2. readings by CUDA events against the same model in bf16; box agreement
    readings = {quant: forward_readings(model, quant) for quant in ("off", "int8_static")}
    from PIL import Image

    images = np.stack([np.asarray(Image.open(os.path.join(calib, f)).convert("RGB").resize(
        (IMAGE, IMAGE)), np.float32) / 255.0 for f in sorted(os.listdir(calib))])
    outs = {quant: make_yolo_predict_batched(model, (IMAGE, IMAGE), COCO_ANCHORS, 80, quant=quant,
                                             **PREDICT_KW)(None, images)
            for quant in ("off", "int8_static")}
    agreement, kept = box_agreement(outs["off"], outs["int8_static"])
    print(f"phase 23 numbers YOLOv4 80 classes @{IMAGE} on [{card}]: forward by CUDA events, "
          f"bf16 b1 p50 {readings['off'][0]:.2f} ms, b16 {readings['off'][1]:.1f} images/s; "
          f"int8 static per-channel b1 p50 {readings['int8_static'][0]:.2f} ms, b16 "
          f"{readings['int8_static'][1]:.1f} images/s; served p50 at b1 ({SERVED_B1_REQUESTS} "
          f"requests) bf16 {served['bf16 b1'][0]:.2f} ms, static {served['static b1'][0]:.2f} ms, "
          f"dynamic {served['dynamic b1'][0]:.2f} ms; served at b16 ({SERVED_B16_REQUESTS} "
          f"requests from 16 clients) bf16 {served['bf16 b16'][1]:.1f} images/s (p50 "
          f"{served['bf16 b16'][0]:.2f} ms), static {served['static b16'][1]:.1f} images/s (p50 "
          f"{served['static b16'][0]:.2f} ms); int8 keeps {agreement:.3f} of bf16's "
          f"{kept} boxes on the 16 calibration scenes (class and IoU >= 0.5; not gated)",
          flush=True)

    # 3. every distinct call of the served forwards and edge cases: kernel = plain
    gen = torch.Generator(device="cuda").manual_seed(0)
    with Int8Calls() as yolo_b1, torch.inference_mode(), quantized("int8_static"):
        model(torch.rand((1, IMAGE, IMAGE, 3), generator=gen, device="cuda"))
    d0, _ = seeded_d0(torch.bfloat16, "cuda")
    d0_images = torch.rand((1, D0_IMAGE, D0_IMAGE, 3), generator=gen, device="cuda")
    prepare_static_int8(d0, calibrate_model(d0, [d0_images]))
    with Int8Calls() as d0_b1, torch.inference_mode(), quantized("int8_static"):
        d0(d0_images)
    with torch.inference_mode():
        quant_b1 = quantize_share(card, yolo_b1.calls,
                                  f"YOLOv4 @{IMAGE} b1 bf16 per-channel forward")
    cases = distinct_calls(yolo_b1.calls) + distinct_calls(d0_b1.calls)
    f32_cases = [(n, x.float(), kq, a.max(), deq, off, ks, s, p, torch.float32)
                 for n, x, kq, a, deq, off, ks, s, p, _ in cases]
    max_err, count = {"int8_conv": 0.0, "int8_dwconv": 0.0}, {"int8_conv": 0, "int8_dwconv": 0}

    def hold(calls):
        with torch.inference_mode():
            for case in calls:
                max_err[case[0]] = max(max_err[case[0]], check_int8_call(*case))
                count[case[0]] += 1

    hold(cases + f32_cases + served_calls + list(int8_edge_calls(gen)))
    print(f"phase 23 kernels vs plain on [{card}]: int8_conv {count['int8_conv']} cases, "
          f"int8_dwconv {count['int8_dwconv']} cases (every distinct call of a YOLOv4 @{IMAGE} "
          f"b1 bf16 per-channel forward and a D0 @{D0_IMAGE} b1 bf16 per-tensor forward, again "
          f"in f32 per-tensor, of the four int8 served paths, and the edge cases in f32/bf16 x "
          f"per-tensor/per-channel): int32 accumulators identical, outputs within "
          f"1e-6·max|plain| (max |kernel - plain| int8_conv {max_err['int8_conv']:.3g}, "
          f"int8_dwconv {max_err['int8_dwconv']:.3g})", flush=True)
    del d0, yolo_b1, d0_b1, cases, f32_cases, served_calls

    # 4. the eval CLI: YOLOv4 per-channel on phase 11's checkpoint, D0 on phase 13's
    yolo_eval = ["--family", "yolo", "--version", "v4", "--imagePath", files["images"],
                 "--classesFile", files["classes"], "--anchorsFile", files["anchors"],
                 "--imageSize", str(TRAIN_IMAGE), "--confidenceThresh", "0.2",
                 "--scoresThresh", "0.05", "--batchSize", "8", "--bf16", "--device", "cuda",
                 "--modelPath", ckpt, "--labelFile", files["labels"]]
    float_map = eval_map.main(yolo_eval)["mAP"]
    int8_conv.launches.update(int8_conv=0, int8_dwconv=0)
    with Int8Calls(distinct=True) as yolo_kept:
        result = eval_map.main(yolo_eval + ["--int8Static", "--int8PerChannel"])
    yolo_launches = int8_conv.launches["int8_conv"]
    check(result["quant"] == "int8_static" and result["images"] == TRAIN_SET,
          f"YOLOv4 int8 eval: {result}")
    check(yolo_launches == 107 * TRAIN_SET // 8, f"YOLOv4 int8 eval: {yolo_launches} launches")
    launches["int8_conv"] += yolo_launches
    d0_eval = ["--family", "efficientdet", "--modelName", "efficientdet-d0", "--imagePath",
               files["images"], "--classesFile", files["classes"], "--imageSize", str(D0_IMAGE),
               "--batchSize", str(D0_TRAIN_BATCH), "--device", "cuda", "--modelPath", d0_ckpt,
               "--labelFile", files["labels"]]
    d0_float = eval_map.main(d0_eval)["mAP"]
    int8_conv.launches.update(int8_conv=0, int8_dwconv=0)
    dwconv.launches = nms_sweep.launches = 0
    with Int8Calls(distinct=True) as d0_kept:
        d0_result = eval_map.main(d0_eval + ["--int8Static"])
    d0_counts = dict(int8_conv.launches, dwconv_bn_swish=dwconv.launches,
                     nms_sweep=nms_sweep.launches)
    eval_cases = distinct_calls(yolo_kept.calls) + distinct_calls(d0_kept.calls)
    hold(eval_cases)
    check(d0_counts["int8_dwconv"] > 0 and d0_counts["dwconv_bn_swish"] == 0,
          f"D0 int8 eval launches: {d0_counts}")
    check(d0_result["quant"] == "int8_static" and d0_result["images"] == TRAIN_SET,
          f"D0 int8 eval: {d0_result}")
    for key in launches:
        launches[key] += d0_counts[key]
    print(f"phase 23 eval on [{card}]: cli.eval_map --int8Static --int8PerChannel, YOLOv4 "
          f"@{TRAIN_IMAGE} bf16 b8 on phase 11's checkpoint: mAP {result['mAP']:.4f} (bf16 "
          f"{float_map:.4f}), int8_conv.launches {yolo_launches}; --family efficientdet "
          f"--int8Static, D0 @{D0_IMAGE} f32 b{D0_TRAIN_BATCH} on phase 13's checkpoint: mAP "
          f"{d0_result['mAP']:.4f} (float {d0_float:.4f}), launches {d0_counts}; the "
          f"{len(eval_cases)} distinct calls of both evals held to the plain versions "
          f"(accumulators identical; max |kernel - plain| int8_conv {max_err['int8_conv']:.3g}, "
          f"int8_dwconv {max_err['int8_dwconv']:.3g} over every case of the phase)", flush=True)
    del yolo_kept, d0_kept, eval_cases

    # 5. times over one forward: YOLOv4 @640 b16 (107 int8_conv), D0 @512 b64 (int8_dwconv)
    with Int8Calls() as yolo_b16, torch.inference_mode(), quantized("int8_static"):
        model(torch.rand((16, IMAGE, IMAGE, 3), generator=gen, device="cuda"))
    check(len(yolo_b16.calls) == 107, f"{len(yolo_b16.calls)} int8 calls in a YOLOv4 forward")
    with torch.inference_mode():
        conv_times = sum_int8_times(card, yolo_b16.calls,
                                    f"int8_conv per YOLOv4 @{IMAGE} b16 bf16 forward")
        conv_times["quantize_ms"], _ = quantize_share(
            card, yolo_b16.calls, f"YOLOv4 @{IMAGE} b16 bf16 per-channel forward")
    conv_times["quantize_b1_ms"], conv_times["quantize_host_us"] = quant_b1
    del yolo_b16, model
    d0, _ = seeded_d0(torch.bfloat16, "cuda")
    prepare_static_int8(d0, calibrate_model(d0, [d0_images]))
    with Int8Calls() as d0_b64, torch.inference_mode(), quantized("int8_static"):
        d0(torch.rand((64, D0_IMAGE, D0_IMAGE, 3), generator=gen, device="cuda"))
    dw_calls = [c for c in d0_b64.calls if c[0] == "int8_dwconv"]
    with torch.inference_mode():
        dw_times = sum_int8_times(card, dw_calls, f"int8_dwconv per D0 @{D0_IMAGE} b64 bf16 forward")
    del d0, d0_b64, dw_calls
    torch.cuda.empty_cache()
    for name, times in (("int8_conv", conv_times), ("int8_dwconv", dw_times)):
        max_err[name] = max(max_err[name], times["max_err"])
    return {"launches": launches, "max_err": max_err, "int8_conv": conv_times,
            "int8_dwconv": dw_times}


def prepared_scene(seed, size):
    """One seeded scene JPEG letterboxed as ``DetectionService`` prepares it →
    ``(1, size, size, 3)`` float32 in [0, 1]."""
    from PIL import Image

    from tmv_tpu_torch.utils import image_helper

    jpeg = scene_jpeg(np.random.default_rng(seed), 720, 1280)
    img = np.asarray(Image.open(io.BytesIO(jpeg)).convert("RGB"), np.uint8)
    boxed, _, _ = image_helper.proportional_resize(img, np.int32((size, size)),
                                                   bg_color=(0, 0, 0))
    return boxed.astype(np.float32)[None] / 255.0


def launches_of(fn):
    """``fn()``'s result and the kernels' launches it made (counts set to 0 just
    before it and read just after)."""
    from tmv_tpu_torch.kernels import dwconv, int8_conv, nms_sweep

    nms_sweep.launches = dwconv.launches = 0
    int8_conv.launches.update(int8_conv=0, int8_dwconv=0)
    out = fn()
    return out, {"nms_sweep": nms_sweep.launches, "dwconv_bn_swish": dwconv.launches,
                 "int8_conv": int8_conv.launches["int8_conv"],
                 "int8_dwconv": int8_conv.launches["int8_dwconv"]}


def hold_artifact(label, live, artifact, image):
    """The artifact against the live predictor on one prepared image: valid rows and
    class ids equal, boxes and scores within one bf16 step + 1e-5·max|live|, and the
    same kernel launches → (kept boxes, launches, max |box diff|, max |score diff|)."""
    import torch

    want, live_launches = launches_of(lambda: live(None, image))
    got, aot_launches = launches_of(lambda: artifact(None, image))
    check(aot_launches == live_launches,
          f"{label}: the artifact launched {aot_launches}, the live path {live_launches}")
    check(np.array_equal(got[3], want[3]), f"{label}: valid rows differ from the live path")
    v = want[3]
    check(v.sum() > 0, f"{label}: the live path kept no box")
    check(np.array_equal(got[1][v], want[1][v]), f"{label}: class ids differ")
    for i, name in ((0, "boxes"), (2, "scores")):
        check(within_one_bf16_step(torch.from_numpy(got[i][v]), torch.from_numpy(want[i][v])),
              f"{label}: {name} beyond one bf16 step of the live path")
    return (int(v.sum()), aot_launches, float(np.abs(got[0][v] - want[0][v]).max()),
            float(np.abs(got[2][v] - want[2][v]).max()))


def forward_p50(run, image, reps=30):
    """b1 forward p50 (ms) of ``run`` on a device tensor, each between CUDA events,
    after 3 warm-up calls."""
    import torch

    x = torch.from_numpy(image).cuda()
    times = []
    with torch.inference_mode():
        for i in range(reps + 3):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            run(x)
            end.record()
            torch.cuda.synchronize()
            if i >= 3:
                times.append(start.elapsed_time(end))
    return statistics.median(times)


def enqueue_us(call, reps=200):
    """Host microseconds to enqueue one ``call()`` (``reps`` back to back, no
    synchronisation inside), after a synchronised warm-up."""
    import torch

    for _ in range(5):
        call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        call()
    per_call = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return per_call


def phase_export(card, weights, d0_weights):
    """Phase 24: the three artifacts (YOLOv4 @640 bf16, its ``--int8Static
    --int8PerChannel`` twin, D0 @512 bf16) exported by ``cli/export_model.py``, served
    by ``serve --artifact`` and held to their live predictors; the YOLOv4 artifact
    once on the host's CPU; the readings."""
    import torch

    from tmv_tpu_torch.cli import export_model, serve
    from tmv_tpu_torch.kernels import int8_conv
    from tmv_tpu_torch.models.yolo_v4 import COCO_ANCHORS
    from tmv_tpu_torch.serving.export import export_file_size, load_predictor

    classes_file, anchors_file = write_inputs(COCO_CLASSES, COCO_ANCHORS)
    calib = int8_calibration_set()
    yolo = ["--modelPath", weights, "--classesFile", classes_file, "--anchorsFile",
            anchors_file, "--imageSize", str(IMAGE), "--bf16", "--device", "cuda",
            "--confidenceThresh", "0.5", "--scoresThresh", "0.2", "--iouThresh", "0.5"]
    cases = [
        ("YOLOv4", yolo, IMAGE, {"nms_sweep": 1}),
        ("YOLOv4 int8", yolo + ["--int8Static", calib, "--int8PerChannel"], IMAGE,
         {"nms_sweep": 1, "int8_conv": 107}),
        ("D0", ["--family", "efficientdet", "--modelName", "efficientdet-d0", "--modelPath",
                d0_weights, "--classesFile", classes_file, "--imageSize", str(D0_IMAGE),
                "--bf16", "--device", "cuda", "--scoresThresh", "0.0001", "--iouThresh", "0.5"],
         D0_IMAGE, {"nms_sweep": 1, "dwconv_bn_swish": 16}),
    ]
    served = {"nms_sweep": 0, "dwconv_bn_swish": 0, "int8_conv": 0}
    yolo_path = yolo_card_out = None
    for n, (label, argv, size, per_forward) in enumerate(cases):
        path = os.path.join(WORK, f"export_{n}.tmvt")
        t0 = time.perf_counter()
        meta = export_model.main(argv + ["--out", path])
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        app, service, _ = serve.build_app(serve.parse_args(
            ["--artifact", path, "--classesFile", classes_file, "--imageSize", str(size),
             "--device", "cuda"]))
        load_s = time.perf_counter() - t0
        artifact = service.predict_fn
        ops = [str(node.target) for node in artifact.program.graph.nodes
               if str(node.target).startswith("tmv.")]
        want_ops = {f"tmv.{k.replace('dwconv_bn_swish', 'dw_bn_swish')}.default": v
                    for k, v in per_forward.items()}
        check({op: ops.count(op) for op in set(ops)} == want_ops,
              f"{label}: the program holds {sorted(ops)}, not {want_ops}")
        live, _ = export_model.live_predictor(export_model.parse_args(argv + ["--out", path]))
        image = prepared_scene(40 + n, size)
        kept, once, box_err, score_err = hold_artifact(label, live, artifact, image)
        check({k: v for k, v in once.items() if v} == per_forward,
              f"{label}: one artifact forward launched {once}, not {per_forward}")
        latencies, _, boxes, counts = drive_server(app, 6, 50 + n)
        for name, per in per_forward.items():
            check(counts[name] >= per * len(latencies) if name == "nms_sweep"
                  else counts[name] == per * len(latencies),
                  f"{label} served: {counts[name]} {name} launches for {len(latencies)} requests")
            served[name] += counts[name]
        module = artifact.program.module()
        aot_ms = forward_p50(module, image)
        live_ms = forward_p50(live.core, image)
        print(f"phase 24 export {label} @{size} bf16 (meta quant {meta['quant']}): exported in "
              f"{export_s:.1f} s, {export_file_size(path) / 1e6:.1f} MB; serve --artifact loaded "
              f"and warm in {load_s:.1f} s; the program holds {dict(sorted(want_ops.items()))}; "
              f"against the live predictor on one prepared scene: {kept} kept boxes, valid rows "
              f"and ids equal, max |box diff| {box_err:.3g}, max |score diff| {score_err:.3g}, "
              f"launches per forward {once}; {len(latencies)} served requests -> HTTP 200, "
              f"{boxes} boxes, launches {counts}; b1 forward p50 by CUDA events: artifact "
              f"{aot_ms:.2f} ms, live {live_ms:.2f} ms, on [{card}]", flush=True)
        if n == 0:
            yolo_path, yolo_image, yolo_card_out = path, image, artifact(None, image)
        if n == 1:
            # the host's cost of one int8_conv launch, through the op and direct
            x = torch.from_numpy(image).cuda().permute(0, 3, 1, 2).to(
                torch.bfloat16).contiguous(memory_format=torch.channels_last)
            site = live.core.model.ConvBN_0
            args = (x, site.kernel_q, site.in_absmax, site.deq, site.offset, 3, 3, 1,
                    [1, 1, 1, 1], False, torch.bfloat16)
            with torch.inference_mode():
                op_us = enqueue_us(lambda: int8_conv.int8_conv_op(*args))
                direct_us = enqueue_us(lambda: int8_conv._conv_cuda(*args))
            print(f"phase 24 enqueue of one int8_conv launch (YOLOv4 ConvBN_0 @{IMAGE} b1, "
                  f"host clock, 200 back to back): through the tmv::int8_conv op "
                  f"{op_us:.1f} us, the direct wrapper {direct_us:.1f} us (107 a forward: "
                  f"+{(op_us - direct_us) * 107 / 1000:.2f} ms) on [{card}]", flush=True)
        del app, service, artifact, live, module
        torch.cuda.empty_cache()

    # the YOLOv4 artifact on the host's CPU: the plain versions, no kernel launched
    t0 = time.perf_counter()
    cpu = load_predictor(yolo_path, device="cpu")
    cpu_load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_out, cpu_launches = launches_of(lambda: cpu(None, yolo_image))
    cpu_s = time.perf_counter() - t0
    check(not any(cpu_launches.values()), f"the CPU run launched {cpu_launches}")
    agree = (box_agreement(yolo_card_out, cpu_out)[0], box_agreement(cpu_out, yolo_card_out)[0])
    check(min(agree) >= 0.9, f"the CPU's YOLOv4 artifact agrees with the card's on {agree}")
    print(f"phase 24 export YOLOv4 artifact on the host's CPU (load_predictor device='cpu'): "
          f"loaded in {cpu_load_s:.1f} s, b1 in {cpu_s:.1f} s through the plain versions, "
          f"launches {cpu_launches}; kept {int(cpu_out[3].sum())} boxes against the card's "
          f"{int(yolo_card_out[3].sum())}: {agree[0]:.3f} of the card's found on the CPU and "
          f"{agree[1]:.3f} of the CPU's on the card (same class, IoU >= 0.5; tolerance 0.9) "
          f"[card {card}]", flush=True)
    return served


# ---------------------------------------------------------------- data parallel

DP_STEPS = 2
DP_LR = 1e-4
DP_LOSS_REL = 1e-3      # phase 11's float32 loss tolerance
DP_UPDATE_REL = 1e-3    # the same bound on the relative L2 error of the parameters' update
DP_FIRST_LOSS_REL = 1e-5   # the first step's loss, taken before any update
DP_LOSS_BAND = 1e-2        # Adam's later losses: a gross band (see phase_parallel)
TWO_RANK_LOSS_REL, TWO_RANK_RTOL, TWO_RANK_ATOL = 2e-3, 1e-3, 5e-4   # dp_equiv_cases' YOLO


def to_device(batch, where):
    """A nested dict/tuple batch's tensors moved to ``where`` (a device or a dtype)."""
    import torch

    if isinstance(batch, dict):
        return {k: to_device(v, where) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(to_device(v, where) for v in batch)
    return batch.to(where) if torch.is_tensor(batch) else batch


def dp_state(files, dtype, lr=DP_LR):
    """Phase 11's YOLOv4 train state at ``lr`` (the trainer's default Adam rate)."""
    state, loss_fn, step, anchors = train_setup(files, dtype, "cuda")
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    return state, step


def two_rank_step(files, batch_path, out_path):
    """One of two ranks sharing the card by gloo (``parallel.mesh.spawn``): the
    YOLOv4 @416 float32 step (TF32 off) under ``DataParallel`` on this rank's rows of
    the saved global b8 batch; rank 0 saves the loss and the ``state_dict``."""
    import torch
    import torch.distributed as dist

    from tmv_tpu_torch.parallel import DataParallel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    dp = DataParallel(devices=["cuda:0", "cuda:0"])
    state, step = dp_state(files, torch.float32)
    dp.put_state(state)
    batch = to_device(dp.put_batch(torch.load(batch_path, weights_only=True)), "cuda")
    metrics = dp.wrap_step(step)(state, batch)
    if dist.get_rank() == 0:
        torch.save({"loss": float(metrics["loss"]), "backend": dist.get_backend(),
                    "model": {k: v.cpu() for k, v in state.model.state_dict().items()}},
                   out_path)


def losses_of(directory):
    with open(os.path.join(directory, "metrics.jsonl")) as f:
        return [json.loads(line)["loss"] for line in f]


def update_error(got, want, start):
    """Relative L2 error of ``got``'s parameter update against ``want``'s, both from
    ``start`` (state_dicts; every float entry)."""
    num = den = 0.0
    for k, w in want.items():
        if w.is_floating_point():
            num += float((got[k].double() - w.double()).norm() ** 2)
            den += float((w.double() - start[k].double()).norm() ** 2)
    return (num / den) ** 0.5


def checkpoint_model(directory, step):
    import torch

    return torch.load(os.path.join(directory, f"{step}.pt"), map_location="cpu",
                      weights_only=True)["model"]


def first_step_f64_gradients(files):
    """The trainer's first step in float64 on the card: its seed-0 YOLOv4 and the first
    batch its pipeline draws (seed 0) → each parameter's gradient, in parameter order."""
    import torch

    from tmv_tpu_torch.data.loaders import load_anchors
    from tmv_tpu_torch.data.yolo_pipeline import YoloDataPipeline

    pipeline = YoloDataPipeline(files["images"], files["labels"], files["classes"], TRAIN_BATCH,
                                load_anchors(files["anchors"]),
                                image_wh=(TRAIN_IMAGE, TRAIN_IMAGE), prefetch=0, device="cuda")
    batches = iter(pipeline)
    batch = to_device(next(batches), torch.float64)
    batches.close()
    state, loss_fn, _, _ = train_setup(files, torch.float64, "cuda")
    model = state.model.to(torch.float64).train()
    loss, _ = loss_fn(model, batch)
    loss.backward()
    grads = {i: p.grad.detach().cpu() for i, p in enumerate(model.parameters())}
    del state, model
    return grads


def first_step_f64_gradients_d0(files):
    """The D0 trainer's first step in float64 on the card (its seed-0 model, the first
    batch of its ``--deviceAug`` pipeline, ``drop_connect`` fed the float32 uniforms
    step 0's seed draws), each gradient clipped to the global norm 10 as the step clips
    it, in parameter order."""
    import torch

    state, loss_fn, _, anchors, generator = d0_train_setup(files, torch.float64, "cuda")
    batches = iter(d0_batches(files, anchors, D0_TRAIN_BATCH, "cuda", prefetch=0))
    batch = to_device(next(batches), torch.float64)
    batches.close()
    model = state.model.to(torch.float64).train()
    generator.manual_seed(0)

    def float32_draws(x, gen):   # the float32 trainer's drop_connect uniforms, exactly
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        return torch.rand(shape, generator=gen, dtype=torch.float32, device=x.device).to(x.dtype)

    with mock.patch("tmv_tpu_torch.models.efficientdet.heads.draw_uniform", float32_draws):
        loss, _ = loss_fn(model, batch)
    loss.backward()
    grads = [p.grad.detach() for p in model.parameters()]
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    scale = torch.clamp(10.0 / (norm + 1e-12), max=1.0)
    out = {i: (g * scale).cpu() for i, g in enumerate(grads)}
    del state, model
    return out


def first_gradients(directory, moment="exp_avg"):
    """Each parameter's gradient of the first step, from the step-1 checkpoint, in the
    optimizer's parameter order: Adam's first moment then is (1 − β1)·g, SGD's
    momentum buffer the (clipped) gradient itself."""
    import torch

    raw = torch.load(os.path.join(directory, "1.pt"), map_location="cpu", weights_only=True)
    scale = 1.0
    if moment == "exp_avg":
        scale = 1 - raw["optimizer"]["param_groups"][0]["betas"][0]
    return {i: s[moment].double() / scale for i, s in raw["optimizer"]["state"].items()}


def init_state_dict(build):
    model = build()
    return {k: v.detach().cpu() for k, v in model.state_dict().items()}


class CheckedDepthwise:
    """Stands in for ``fused_dw_bn_swish`` in D0's backbone: the kernel, then the
    plain version on the same inputs (no launch), each launch held to it within one
    bf16 step + 1e-5·max|plain| (phase 7's bf16 tolerance)."""

    def __init__(self):
        from tmv_tpu_torch.kernels.dwconv import fused_dw_bn_swish

        self.kernel, self.agree, self.halo_padded = fused_dw_bn_swish, [], 0

    def __call__(self, x, w, scale, offset, stride=1, row_pads=None):
        from tmv_tpu_torch.kernels.dwconv import dw_bn_swish_reference

        out = self.kernel(x, w, scale, offset, stride, row_pads=row_pads)
        self.agree.append(within_one_bf16_step(out, dw_bn_swish_reference(
            x, w, scale, offset, stride, row_pads)))
        self.halo_padded += row_pads is not None
        return out

    def patch(self):
        return mock.patch("tmv_tpu_torch.models.efficientdet.backbone.fused_dw_bn_swish", self)


def phase_parallel(card, files, weights, d0_weights):
    """Phase 25: data-parallel training through the CLIs and sharded serving."""
    import torch
    import torch.distributed as dist

    from tmv_tpu_torch.cli import eval_map, serve, train_efficientdet, train_yolo
    from tmv_tpu_torch.core.checkpoint import load_weights
    from tmv_tpu_torch.kernels import dwconv, nms_sweep
    from tmv_tpu_torch.models.efficientdet.harness import build_efficientdet
    from tmv_tpu_torch.models.efficientdet.net import init_weights as d0_init
    from tmv_tpu_torch.models.yolo_v4 import COCO_ANCHORS
    from tmv_tpu_torch.parallel import (
        DataParallel, FullyShardedDataParallel, make_sharded_batched_predictor,
    )
    from tmv_tpu_torch.parallel.mesh import spawn

    t_phase = time.perf_counter()
    cards = torch.cuda.device_count()
    launches = {"nms_sweep": 0, "dwconv_bn_swish": 0, "int8_conv": 0}
    root = os.path.join(WORK, "parallel")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    marks = []

    def mark(name):
        marks.append(f"{name} {time.perf_counter() - t_phase:.1f} s")

    # serve --dp 2 on a one-card host must stop with the reason: started now, read last
    classes_file, anchors_file = write_inputs(COCO_CLASSES, COCO_ANCHORS)
    refusal = None
    if cards < 2:
        refusal = subprocess.Popen(
            [sys.executable, "-m", "tmv_tpu_torch.cli.serve", "--randomInit", "--classesFile",
             classes_file, "--anchorsFile", anchors_file, "--imageSize", str(IMAGE), "--batch",
             "16", "--dp", "2"], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)

    # two ranks on the one card (gloo; the probe of PERF.md §6), started first: they
    # build and step while the CLIs run here
    from tmv_tpu_torch.data.loaders import load_anchors
    from tmv_tpu_torch.data.yolo_pipeline import YoloDataPipeline

    pipeline = YoloDataPipeline(files["images"], files["labels"], files["classes"], TRAIN_BATCH,
                                load_anchors(files["anchors"]),
                                image_wh=(TRAIN_IMAGE, TRAIN_IMAGE), prefetch=0, device="cpu")
    batches = iter(pipeline)
    batch = next(batches)
    batches.close()
    batch_path, two_path = os.path.join(root, "batch.pt"), os.path.join(root, "two_rank.pt")
    torch.save(batch, batch_path)
    two_ranks = spawn(two_rank_step, 2, files, batch_path, two_path,
                      devices=["cuda:0", "cuda:0"], join=False)

    # YOLOv4 @416 global b8 float32: the trainer plain and under --dp and --fsdp (NCCL,
    # one rank per card), DP_STEPS steps each from the same seed and batches (one step an
    # epoch, so each step's checkpoint is kept), cuDNN deterministic. Held by phase 11's
    # rule: the first step's gradients (Adam's first moment at step 1 is (1 − β1)·g)
    # within 2x the plain float32 step's distance from the float64 step + 1e-4 (train-mode
    # BatchNorm at random init amplifies rounding through the layers, so float32 sits far
    # from float64 whichever way its statistics are summed). Adam's first steps move each
    # weight by about lr·sign(g), so rounding-level differences flip the step of
    # near-zero gradients whole and the later losses drift (dp_equiv_cases): they are
    # held to a gross band.
    torch.backends.cudnn.deterministic = True
    yolo_argv = ["--trainData", files["labels"], "--trainImagePath", files["images"],
                 "--classesFile", files["classes"], "--anchorsFile", files["anchors"],
                 "--imageSize", str(TRAIN_IMAGE), "--batchSize", str(TRAIN_BATCH),
                 "--stepsPerEpoch", "1", "--epochs", str(DP_STEPS), "--lr", str(DP_LR),
                 "--earlyStopPatience", "0", "--reduceLrPatience", "0", "--device", "cuda"]
    dirs = {m: os.path.join(root, f"yolo_{m}") for m in ("plain", "dp", "fsdp")}
    seconds = {}
    for mode, directory in dirs.items():
        flags = [f"--{mode}"] if mode in ("dp", "fsdp") else []
        if mode == "dp":   # the val pass, through the sweep kernel
            flags += ["--valData", files["val"], "--valImagePath", files["images"]]
        nms_sweep.launches = 0
        t0 = time.perf_counter()
        train_yolo.main(yolo_argv + ["--modelPath", directory] + flags)
        seconds[mode] = time.perf_counter() - t0
        check(not dist.is_initialized(), f"the {mode} run left its process group up")
        if mode == "dp":
            val_launches = nms_sweep.launches
    reference = first_step_f64_gradients(files)
    # with more cards the ranks are processes of their own and count there
    check(val_launches >= VAL_SET or cards > 1,
          f"the --dp val pass launched {val_launches} sweeps")
    launches["nms_sweep"] += val_launches
    losses = {m: losses_of(d) for m, d in dirs.items()}
    loss_rel, grad_err = {}, {}
    for mode in ("plain", "dp", "fsdp"):
        loss_rel[mode] = [abs(a - b) / abs(b) for a, b in zip(losses[mode], losses["plain"])]
        grad_err[mode] = rel_l2(first_gradients(dirs[mode]), reference)
    for mode in ("dp", "fsdp"):
        check(len(losses[mode]) == DP_STEPS and loss_rel[mode][0] <= DP_FIRST_LOSS_REL,
              f"YOLOv4 --{mode} first loss {losses[mode][0]} vs plain {losses['plain'][0]}")
        check(all(g <= 2 * f + 1e-4 for g, f in zip(grad_err[mode], grad_err["plain"])),
              f"YOLOv4 --{mode} first gradients {grad_err[mode]} from float64, plain's "
              f"{grad_err['plain']}")
        check(max(loss_rel[mode]) <= DP_LOSS_BAND,
              f"YOLOv4 --{mode} losses {losses[mode]} vs plain {losses['plain']}")
    print(f"phase 25 YOLOv4 @{TRAIN_IMAGE} global b{TRAIN_BATCH} f32 (TF32 off, cuDNN "
          f"deterministic) {DP_STEPS} steps of Adam at {DP_LR} through "
          f"tmv_tpu_torch.cli.train_yolo --dp and --fsdp (NCCL, world {cards}) against plain: "
          f"losses --dp {[round(x, 4) for x in losses['dp']]}, --fsdp "
          f"{[round(x, 4) for x in losses['fsdp']]}, plain "
          f"{[round(x, 4) for x in losses['plain']]}; the first step's loss relative "
          f"difference --dp {loss_rel['dp'][0]:.3g}, --fsdp {loss_rel['fsdp'][0]:.3g} "
          f"(tolerance {DP_FIRST_LOSS_REL}); its gradients' relative L2 error from the "
          f"float64 step on the card (overall, worst tensor) --dp {grad_err['dp'][0]:.3g}, "
          f"{grad_err['dp'][1]:.3g}, --fsdp {grad_err['fsdp'][0]:.3g}, "
          f"{grad_err['fsdp'][1]:.3g}, plain {grad_err['plain'][0]:.3g}, "
          f"{grad_err['plain'][1]:.3g} (tolerance 2x plain's + 1e-4); the worst later loss "
          f"--dp {max(loss_rel['dp']):.3g}, --fsdp {max(loss_rel['fsdp']):.3g} (band "
          f"{DP_LOSS_BAND}); the --dp run's val passes {val_launches} sweep "
          f"launches; CLI runs {seconds['dp']:.1f} s (--dp, with val) / "
          f"{seconds['fsdp']:.1f} s (--fsdp) / {seconds['plain']:.1f} s (plain) on [{card}]",
          flush=True)

    mark("YOLOv4 CLIs")
    # D0 @512 global b16 float32: --fsdp against --dp, its checkpoint served and scored
    d0_argv = ["--modelName", "efficientdet-d0", "--trainData", files["labels"],
               "--trainImagePath", files["images"], "--classesFile", files["classes"],
               "--imageSize", str(D0_IMAGE), "--batchSize", str(D0_TRAIN_BATCH),
               "--stepsPerEpoch", "1", "--epochs", str(DP_STEPS), "--deviceAug",
               "--earlyStopPatience", "0", "--device", "cuda"]
    d0_dirs = {m: os.path.join(root, f"d0_{m}") for m in ("fsdp", "dp")}
    for mode, directory in d0_dirs.items():
        train_efficientdet.main(d0_argv + ["--modelPath", directory, f"--{mode}"])
    torch.backends.cudnn.deterministic = False
    d0_losses = {m: losses_of(d) for m, d in d0_dirs.items()}
    d0_start = init_state_dict(lambda: d0_init(build_efficientdet(
        "efficientdet-d0", 81, D0_IMAGE, device="cpu")[0], 0))
    d0_err = update_error(checkpoint_model(d0_dirs["fsdp"], DP_STEPS),
                          checkpoint_model(d0_dirs["dp"], DP_STEPS), d0_start)
    d0_reference = first_step_f64_gradients_d0(files)
    d0_grad = {m: rel_l2(first_gradients(d, "momentum_buffer"), d0_reference)
               for m, d in d0_dirs.items()}
    d0_loss_rel = [abs(a - b) / abs(b) for a, b in zip(d0_losses["fsdp"], d0_losses["dp"])]
    check(len(d0_losses["fsdp"]) == DP_STEPS and d0_loss_rel[0] <= DP_FIRST_LOSS_REL,
          f"D0 --fsdp first loss {d0_losses['fsdp'][0]} vs --dp {d0_losses['dp'][0]}")
    check(all(g <= 2 * f + 1e-4 for g, f in zip(d0_grad["fsdp"], d0_grad["dp"])),
          f"D0 --fsdp first gradients {d0_grad['fsdp']} from float64, --dp's {d0_grad['dp']}")
    check(max(d0_loss_rel) <= DP_LOSS_BAND,
          f"D0 --fsdp losses {d0_losses['fsdp']} vs --dp {d0_losses['dp']}")
    d0_serve = ["--family", "efficientdet", "--modelName", "efficientdet-d0", "--modelPath",
                d0_dirs["fsdp"], "--classesFile", files["classes"], "--imageSize", str(D0_IMAGE),
                "--device", "cuda"]
    app, _, _ = serve.build_app(serve.parse_args(d0_serve + ["--bf16"]))
    _, _, _, counts = drive_server(app, 2, 71)
    check(counts["dwconv_bn_swish"] == 32 and counts["nms_sweep"] >= 2,
          f"serving the --fsdp checkpoint launched {counts}")
    nms_sweep.launches = dwconv.launches = 0
    scored = eval_map.main(["--family", "efficientdet", "--modelName", "efficientdet-d0",
                            "--modelPath", d0_dirs["fsdp"], "--imagePath", files["images"],
                            "--labelFile", files["val"], "--classesFile", files["classes"],
                            "--imageSize", str(D0_IMAGE), "--device", "cuda"])
    check(scored["images"] == VAL_SET and 0 <= scored["mAP"] <= 1,
          f"eval_map on the --fsdp checkpoint: {scored}")
    launches["nms_sweep"] += counts["nms_sweep"] + nms_sweep.launches
    launches["dwconv_bn_swish"] += counts["dwconv_bn_swish"] + dwconv.launches
    print(f"phase 25 D0 @{D0_IMAGE} global b{D0_TRAIN_BATCH} f32 (TF32 off) {DP_STEPS} steps "
          f"through tmv_tpu_torch.cli.train_efficientdet --fsdp against --dp (world {cards}): "
          f"losses {[round(x, 4) for x in d0_losses['fsdp']]} vs "
          f"{[round(x, 4) for x in d0_losses['dp']]} (first step relative "
          f"{d0_loss_rel[0]:.3g}, tolerance {DP_FIRST_LOSS_REL}; the worst later "
          f"{max(d0_loss_rel):.3g}, band {DP_LOSS_BAND}); the first step's clipped gradients' "
          f"relative L2 error from the float64 step (overall, worst tensor) --fsdp "
          f"{d0_grad['fsdp'][0]:.3g}, {d0_grad['fsdp'][1]:.3g}, --dp {d0_grad['dp'][0]:.3g}, "
          f"{d0_grad['dp'][1]:.3g} (tolerance 2x --dp's + 1e-4); the parameters' update "
          f"relative L2 error after {DP_STEPS} steps {d0_err:.3g}; its checkpoint served by "
          f"serve --family efficientdet "
          f"(2 requests, {counts['dwconv_bn_swish']} depthwise and {counts['nms_sweep']} sweep "
          f"launches) and scored by eval_map on the {VAL_SET} val images: mAP "
          f"{scored['mAP']:.4f} on [{card}]", flush=True)
    del app

    mark("D0 CLIs, serve, eval")
    # the two ranks on the one card against the plain b8 step
    while not two_ranks.join():
        pass
    state, step = dp_state(files, torch.float32)
    torch.backends.cudnn.deterministic = True
    plain_loss = float(step(state, to_device(batch, "cuda"))["loss"])
    torch.backends.cudnn.deterministic = False
    two = torch.load(two_path, weights_only=True)
    worst = 0.0
    for k, v in state.model.state_dict().items():
        if v.is_floating_point():
            want, got = v.double().cpu(), two["model"][k].double()
            excess = float(((got - want).abs() - TWO_RANK_RTOL * want.abs()).max())
            worst = max(worst, excess)
    check(abs(two["loss"] - plain_loss) <= TWO_RANK_LOSS_REL * abs(plain_loss),
          f"two ranks' loss {two['loss']} vs plain {plain_loss}")
    check(worst <= TWO_RANK_ATOL, f"two ranks' parameters off by {worst:.3g} beyond rtol")
    print(f"phase 25 two ranks on one card ({two['backend']}, cuda:0 twice) x b4 YOLOv4 @"
          f"{TRAIN_IMAGE} f32 step against the plain b8 step: loss {two['loss']:.5f} vs "
          f"{plain_loss:.5f} (tolerance rel {TWO_RANK_LOSS_REL}); parameters and running "
          f"statistics within rtol {TWO_RANK_RTOL} + {worst:.3g} (atol {TWO_RANK_ATOL}) on "
          f"[{card}]", flush=True)
    del state, step

    # serve --dp: two replicas on the one card against one, YOLOv4 b16 (float and
    # --int8Static --int8PerChannel) and D0 b64, bf16
    mark("the two ranks")
    calib = int8_calibration_set()
    yolo_flags = ["--modelPath", weights, "--classesFile", classes_file, "--anchorsFile",
                  anchors_file, "--imageSize", str(IMAGE), "--bf16", "--device", "cuda"]
    d0_flags = ["--family", "efficientdet", "--modelName", "efficientdet-d0", "--modelPath",
                d0_weights, "--classesFile", classes_file, "--imageSize", str(D0_IMAGE),
                "--bf16", "--device", "cuda"]
    scenes = {IMAGE: np.concatenate([prepared_scene(80 + i, IMAGE) for i in range(16)]),
              D0_IMAGE: np.concatenate([prepared_scene(80 + i, D0_IMAGE) for i in range(16)])}
    readings = {}
    for label, flags, quant, batch_size in (
            ("YOLOv4", yolo_flags, "off", 16),
            ("YOLOv4 int8", yolo_flags + ["--int8Static", calib, "--int8PerChannel"],
             "int8_static", 16),
            ("D0", d0_flags, "off", 64)):
        args = serve.parse_args(flags + ["--batch", str(batch_size)])
        size = args.imageSize
        model, make_batched, _ = serve._build_model(args, 80, torch.bfloat16)
        load_weights(model, args.modelPath)
        model = model.to(device="cuda", memory_format=torch.channels_last).eval()
        if quant == "int8_static":
            from tmv_tpu_torch.quant.static import calibrate_directory

            calibrate_directory(model, calib, (size, size), per_channel=True)
        one = make_batched(quant, model)
        two_replicas, _, devices = make_sharded_batched_predictor(
            model, lambda replica: make_batched(quant, replica), devices=["cuda:0", "cuda:0"])
        images = np.tile(scenes[size], (batch_size // 16, 1, 1, 1))
        want = one(None, images)
        sweep, depthwise = CheckedSweep(), CheckedDepthwise()
        with sweep.patch(), depthwise.patch():
            got, used = launches_of(lambda: two_replicas(None, images))
        check(sweep.agree and all(sweep.agree), f"{label} --dp: a sweep's mask differs")
        check(all(depthwise.agree), f"{label} --dp: a depthwise launch differs")
        agree = (box_agreement(want, got)[0], box_agreement(got, want)[0])
        check(min(agree) >= 0.98 and want[3].sum() > 0,
              f"{label} two replicas against one: agreement {agree}")
        for name in launches:
            launches[name] += used[name]
        lone, _, _ = make_sharded_batched_predictor(
            model, lambda replica: make_batched(quant, replica), devices=["cuda:0"])
        lone(None, images)
        one_ms = host_ms(lambda: one(None, images), 3)
        two_ms = host_ms(lambda: two_replicas(None, images), 3)
        lone_ms = host_ms(lambda: lone(None, images), 3)
        lone.close()
        readings[label] = (batch_size * 1000 / one_ms, batch_size * 1000 / two_ms,
                           batch_size * 1000 / lone_ms)
        print(f"phase 25 serve --dp {label} @{size} b{batch_size} bf16 over {devices}: "
              f"{len(sweep.agree)} sweeps each equal to the plain sweep (whole masks), "
              f"{len(depthwise.agree)} depthwise launches each within one bf16 step of the "
              f"plain version; launches {used}; detections against the one-device predictor "
              f"{agree[0]:.4f} / {agree[1]:.4f} (IoU >= 0.5, same class; tolerance 0.98); "
              f"images/s (host clock, median of 3 calls) one replica "
              f"{readings[label][0]:.1f}, two replicas on the one card {readings[label][1]:.1f}, "
              f"one replica through shard_predict (its own thread and stream) "
              f"{readings[label][2]:.1f} on [{card}]", flush=True)
        two_replicas.close()
        del model, one, two_replicas
        torch.cuda.empty_cache()
    mark("serve --dp predictors")
    app, service, _ = serve.build_app(serve.parse_args(
        ["--randomInit", "--classesFile", classes_file, "--anchorsFile", anchors_file,
         "--imageSize", str(IMAGE), "--bf16", "--batch", "16", "--dp", "1"]))
    latencies, _, boxes_seen, counts = drive_server(app, 6, 73)
    service.batcher.close()
    check(len(latencies) == 6 and counts["nms_sweep"] >= 6,
          f"serve --dp 1 answered {len(latencies)} requests, {counts['nms_sweep']} sweeps")
    launches["nms_sweep"] += counts["nms_sweep"]
    refused = ""
    if refusal is not None:
        _, stderr = refusal.communicate(timeout=120)
        refused = (stderr.strip().splitlines() or [""])[-1]
        check(refusal.returncode != 0 and "2 replicas need 2 GPUs" in stderr,
              f"serve --dp 2 on {cards} card(s): exit {refusal.returncode}, {stderr[-500:]}")
    print(f"phase 25 serve --dp 1 --batch 16 answered 6 requests (p50 "
          f"{statistics.median(latencies):.1f} ms, {boxes_seen} boxes, {counts['nms_sweep']} "
          f"sweeps); serve --dp 2 on {cards} card(s): {refused or 'not run (two cards)'} on "
          f"[{card}]", flush=True)
    del app, service

    mark("serve --dp 1 and 2")
    # readings: the steps by CUDA events after warm-up (world 1, NCCL), in turns
    dp = DataParallel(device="cuda")
    fsdp = FullyShardedDataParallel(device="cuda")
    from tmv_tpu_torch.models.layers import common

    step_ms = {}
    for dtype, name in ((torch.bfloat16, "bf16"),):
        plain_state, plain_step = dp_state(files, dtype)
        dp_state_, raw = dp_state(files, dtype)
        dp.put_state(dp_state_)
        dp_step = dp.wrap_step(raw)
        on = to_device(batch, "cuda")
        for _ in range(2):
            plain_step(plain_state, on), dp_step(dp_state_, on)
        local_bn = mock.patch.object(common, "data_group", lambda: None)
        t = []
        for fn in (lambda: plain_step(plain_state, on), lambda: dp_step(dp_state_, on),
                   lambda: dp_step(dp_state_, on), lambda: plain_step(plain_state, on)):
            t.append(cuda_ms(fn, 3))
        with local_bn:
            t_local = cuda_ms(lambda: dp_step(dp_state_, on), 3)
        step_ms[name] = ((t[0] + t[3]) / 2, (t[1] + t[2]) / 2, t_local)
        del plain_state, dp_state_
        torch.cuda.empty_cache()
    bn_share = {k: (v[1] - v[2]) / v[1] for k, v in step_ms.items()}
    print(f"phase 25 YOLOv4 @{TRAIN_IMAGE} b{TRAIN_BATCH} step ms (CUDA events, 3 steps, "
          f"turns plain, DP, DP, plain, after 2 warm-up steps; DP at world 1 by NCCL): "
          + "; ".join(f"{k}: plain {v[0]:.2f}, DP {v[1]:.2f} ({(v[1] / v[0] - 1) * 100:+.1f}%), "
                      f"DP with rank-local BatchNorm {v[2]:.2f} (the global BatchNorm's share "
                      f"{bn_share[k] * 100:.1f}%)" for k, v in step_ms.items())
          + f" on [{card}]", flush=True)
    mark("YOLOv4 step readings")
    d0_ms, peaks, d0_batch = {}, {}, None
    for mode in ("plain", "dp", "fsdp"):
        state, _, step, anchors, _ = d0_train_setup(files, torch.bfloat16, "cuda")
        if d0_batch is None:
            d0_batch = next(iter(d0_batches(files, anchors, D0_TRAIN_BATCH, "cuda", prefetch=0)))
        if mode != "plain":
            wrapper = dp if mode == "dp" else fsdp
            wrapper.put_state(state)
            step = wrapper.wrap_step(step)
        step(state, d0_batch)
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        step(state, d0_batch)
        torch.cuda.synchronize()
        peaks[mode] = (torch.cuda.max_memory_allocated() - resident) / 2 ** 30
        d0_ms[mode] = cuda_ms(lambda: step(state, d0_batch), 2)
        del state, step
        torch.cuda.empty_cache()
    print(f"phase 25 D0 @{D0_IMAGE} b{D0_TRAIN_BATCH} bf16 step ms (CUDA events, 2 steps "
          f"after 2; world 1 by NCCL): plain {d0_ms['plain']:.2f}, DP {d0_ms['dp']:.2f}, FSDP "
          f"{d0_ms['fsdp']:.2f}; a step's peak above the resident state: plain "
          f"{peaks['plain']:.3f} GiB, DP {peaks['dp']:.3f} GiB, FSDP {peaks['fsdp']:.3f} GiB "
          f"on [{card}]", flush=True)
    dist.destroy_process_group()
    mark("D0 step readings")
    elapsed = time.perf_counter() - t_phase
    print(f"phase 25 parts: {'; '.join(marks)} on [{card}]", flush=True)
    return {"launches": launches, "seconds": elapsed, "step_ms": step_ms, "d0_ms": d0_ms,
            "peaks": peaks, "serve": readings, "yolo_argv": yolo_argv, "plain": dirs["plain"],
            "reference": reference, "plain_grad_err": grad_err["plain"]}


# ---------------------------------------------------------------- the spatial axis

SP_REQUESTS = 4      # b1 requests through each height-sharded server


def sp_trainer_rank(argv):
    """One of two ranks sharing the card (``parallel.mesh.spawn``, gloo) that runs the
    trainer CLI as under torchrun: float32 with TF32 off and cuDNN deterministic, as
    phase 25's plain run."""
    import torch

    from tmv_tpu_torch.cli import train_yolo

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    train_yolo.main(argv)


def phase_spatial(card, files, weights, d0_weights, parallel):
    """Phase 26: the spatial axis. ``serve --spatial 2`` over ``[cuda:0, cuda:0]`` for
    YOLOv4 @640 bf16, its ``--int8Static --int8PerChannel`` twin and D0 @512 bf16, each
    answering b1 requests through the HTTP app held to the unsharded predictor on the
    same letterboxed frames (every sweep's whole mask equal; for YOLOv4 bf16 the
    detections, and the whole masks through float32 predictors; the kernel's masks
    equal to the plain sweep's), every depthwise launch on a halo-padded shard within
    one bf16 step of the plain version and every distinct int8 call checked as phase
    23 does;
    then ``train_yolo --sp 2`` (two gloo ranks on the card, YOLOv4 @416 global b8
    float32, started first) against phase 25's plain run by its rules."""
    import torch

    from tmv_tpu_torch.cli import serve
    from tmv_tpu_torch.kernels.nms_sweep import greedy_sweep
    from tmv_tpu_torch.models.yolo_v4 import COCO_ANCHORS
    from tmv_tpu_torch.parallel.mesh import spawn

    t_phase = time.perf_counter()
    root = os.path.join(WORK, "spatial")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    sp_dir = os.path.join(root, "yolo_sp")
    ranks = spawn(sp_trainer_rank, 2, parallel["yolo_argv"] + ["--modelPath", sp_dir, "--sp", "2"],
                  devices=["cuda:0", "cuda:0"], join=False)

    classes_file, anchors_file = write_inputs(COCO_CLASSES, COCO_ANCHORS)
    calib = int8_calibration_set()
    yolo_flags = ["--modelPath", weights, "--classesFile", classes_file, "--anchorsFile",
                  anchors_file, "--imageSize", str(IMAGE), "--bf16", "--device", "cuda"]
    d0_flags = ["--family", "efficientdet", "--modelName", "efficientdet-d0", "--modelPath",
                d0_weights, "--classesFile", classes_file, "--imageSize", str(D0_IMAGE),
                "--bf16", "--device", "cuda"]
    launches = {"nms_sweep": 0, "dwconv_bn_swish": 0, "int8_conv": 0, "int8_dwconv": 0}
    readings, int8_err, served = {}, 0.0, []
    for seed, (label, flags, quant) in enumerate((
            ("YOLOv4", yolo_flags, "off"),
            ("YOLOv4 int8", yolo_flags + ["--int8Static", calib, "--int8PerChannel"],
             "int8_static"),
            ("D0", d0_flags, "off"))):
        args = serve.parse_args(flags + ["--spatial", "2"])
        app, service, model = serve.build_app(args, devices=["cuda:0", "cuda:0"])
        _, make_batched, _ = serve._build_model(args, 80, torch.bfloat16)
        one = make_batched(quant, model)           # the unsharded predictor, same module
        frames, outs, sharded = [], [], service.predict_fn

        def recorded(variables, frame, sharded=sharded):
            frames.append(np.array(frame))
            outs.append(sharded(variables, frame))
            return outs[-1]

        service.predict_fn = recorded
        sweep, depthwise, calls = CheckedSweep(), CheckedDepthwise(), Int8Calls(distinct=True)
        with sweep.patch(), depthwise.patch(), calls:
            latencies, _, boxes_seen, used = drive_server(app, SP_REQUESTS, 90 + seed)
        plain = SweepLog(greedy_sweep)
        with plain.patch():
            wants = [tuple(o[0] for o in one(None, frame)) for frame in frames]
        bits = [int((a != b).sum()) for a, b in zip(sweep.masks, plain.masks)]
        check(len(frames) == SP_REQUESTS and len(sweep.masks) == len(plain.masks),
              f"{label} --spatial 2: {len(frames)} frames, {len(sweep.masks)} sweeps")
        check(all(sweep.agree), f"{label} --spatial 2: a kernel sweep differs from the plain")
        check(all(depthwise.agree), f"{label} --spatial 2: a depthwise launch differs")
        check(used["nms_sweep"] >= SP_REQUESTS and (label != "D0" or depthwise.halo_padded
                                                    == used["dwconv_bn_swish"] > 0),
              f"{label} --spatial 2 launched {used}")
        if label == "YOLOv4":
            # bf16 YOLOv4: cuDNN's bf16 convs at a shard's shapes sum in another order
            # (its f32 ones do not: the f32 twin below is exact), as serve --dp's
            # replicas' batch shapes do: held by phase 25's detection rule, and the
            # same frames through float32 predictors of the weights by whole masks
            agree = (box_agreement(stack_outs(wants), stack_outs(outs))[0],
                     box_agreement(stack_outs(outs), stack_outs(wants))[0])
            check(min(agree) >= 0.98, f"YOLOv4 --spatial 2 detections {agree}")
            exact = f32_spatial_masks(args, frames)
            check(exact[0] == exact[1] and exact[0] > 0,
                  f"YOLOv4 f32 --spatial 2: {exact[0]} of {exact[1]} whole masks equal")
            held = (f"detections against the unsharded predictor's {agree[0]:.4f} / "
                    f"{agree[1]:.4f} (IoU >= 0.5, same class; tolerance 0.98), whole masks "
                    f"differing in {bits} of {[int(m.sum()) for m in plain.masks]} kept bits; "
                    f"the same frames in f32 (TF32 off) sharded and unsharded: {exact[0]} of "
                    f"{exact[1]} sweeps' whole masks equal")
        else:
            check(sum(bits) == 0, f"{label} --spatial 2: whole masks differ by {bits} bits")
            held = (f"{len(sweep.masks)} sweeps' whole masks equal to the unsharded "
                    f"predictor's on the same frames")
        checked = distinct_calls(calls.calls)
        for call in checked:
            int8_err = max(int8_err, check_int8_call(*call))
        check(bool(checked) == (quant == "int8_static"), f"{label}: {len(checked)} int8 calls")
        for name in launches:
            launches[name] += used.get(name, 0)
        served.append((label, app, sharded, one, frames[0]))
        print(f"phase 26 serve --spatial 2 {label} @{args.imageSize} bf16 over [cuda:0, cuda:0]: "
              f"{SP_REQUESTS} b1 requests -> HTTP 200 ({boxes_seen} boxes); {held}; each "
              f"kernel sweep's mask equal to the plain sweep's; {len(depthwise.agree)} "
              f"depthwise launches ({depthwise.halo_padded} on halo-padded shards) within one "
              f"bf16 step of the plain version; {len(checked)} distinct int8 calls held to the "
              f"plain versions; launches {used} on [{card}]", flush=True)
    serving_s = time.perf_counter() - t_phase

    while not ranks.join():
        pass
    ranks_s = time.perf_counter() - t_phase
    # the readings once the ranks have left the card and the host's cores
    for seed, (label, app, sharded, one, frame) in enumerate(served):
        latencies, _, _, used = drive_server(app, SP_REQUESTS, 95 + seed)
        for name in launches:
            launches[name] += used.get(name, 0)
        readings[label] = (statistics.median(latencies), host_ms(lambda: sharded(None, frame), 10),
                           host_ms(lambda: one(None, frame), 10))
    print(f"phase 26 readings on [{card}] (b1; served: {SP_REQUESTS} more requests, p50; the "
          f"predictor: host clock, median of 10 calls on one frame): " + "; ".join(
              f"{label} served {v[0]:.1f} ms, predictor height-sharded over [cuda:0, cuda:0] "
              f"{v[1]:.2f} ms, unsharded {v[2]:.2f} ms" for label, v in readings.items()),
          flush=True)
    del served
    torch.cuda.empty_cache()
    losses = losses_of(sp_dir)
    plain_losses = losses_of(parallel["plain"])
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(losses, plain_losses)]
    grad_err = rel_l2(first_gradients(sp_dir), parallel["reference"])
    plain_err = parallel["plain_grad_err"]
    check(len(losses) == DP_STEPS and loss_rel[0] <= DP_FIRST_LOSS_REL,
          f"YOLOv4 --sp 2 first loss {losses[0]} vs plain {plain_losses[0]}")
    check(grad_err[0] <= 2 * plain_err[0] + 1e-4 and grad_err[1] <= 2 * plain_err[1] + 1e-4,
          f"YOLOv4 --sp 2 first gradients {grad_err} from float64, plain's {plain_err}")
    check(max(loss_rel) <= DP_LOSS_BAND, f"YOLOv4 --sp 2 losses {losses} vs plain {plain_losses}")
    print(f"phase 26 train_yolo --sp 2 (two gloo ranks on cuda:0, data 1 x space 2) YOLOv4 "
          f"@{TRAIN_IMAGE} global b{TRAIN_BATCH} f32 (TF32 off, cuDNN deterministic) {DP_STEPS} "
          f"steps of Adam at {DP_LR} against phase 25's plain run: losses "
          f"{[round(x, 4) for x in losses]} vs {[round(x, 4) for x in plain_losses]}; the first "
          f"step's loss relative difference {loss_rel[0]:.3g} (tolerance {DP_FIRST_LOSS_REL}); "
          f"its gradients' relative L2 error from the float64 step (overall, worst tensor) "
          f"{grad_err[0]:.3g}, {grad_err[1]:.3g}, plain {plain_err[0]:.3g}, {plain_err[1]:.3g} "
          f"(tolerance 2x plain's + 1e-4); the worst later loss {max(loss_rel):.3g} (band "
          f"{DP_LOSS_BAND}); the servers' checks ended at {serving_s:.1f} s, the ranks at "
          f"{ranks_s:.1f} s on [{card}]", flush=True)
    return {"launches": launches, "int8_err": int8_err, "readings": readings}


def stack_outs(outs):
    """Per-image predictor outputs (boxes, ids, scores, valid) stacked on a batch axis."""
    return tuple(np.stack([o[k] for o in outs]) for k in range(4))


def f32_spatial_masks(args, frames):
    """(sweeps whose whole masks agree, sweeps) of ``frames`` through the float32 (TF32
    off) predictors of ``args``' weights: unsharded and over ``[cuda:0, cuda:0]``."""
    import torch

    from tmv_tpu_torch.cli import serve
    from tmv_tpu_torch.core.checkpoint import load_weights
    from tmv_tpu_torch.kernels.nms_sweep import greedy_sweep
    from tmv_tpu_torch.parallel.inference import make_spatial_predictor

    model, make_batched, _ = serve._build_model(args, 80, torch.float32)
    load_weights(model, args.modelPath)
    model = model.to(device="cuda", memory_format=torch.channels_last).eval()
    one = make_batched("off", model)
    sharded, _, _ = make_spatial_predictor(model, lambda f: make_batched("off", f),
                                           devices=["cuda:0", "cuda:0"])
    a, b = SweepLog(greedy_sweep), SweepLog(greedy_sweep)
    for frame in frames:
        with a.patch():
            one(None, frame)
        with b.patch():
            sharded(None, frame)
    sharded.close()
    equal = sum(np.array_equal(x, y) for x, y in zip(a.masks, b.masks))
    return equal, len(a.masks)


def _side_main(fn, path, args):
    import pickle

    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = fn(*args)
    with open(path, "wb") as f:
        pickle.dump(out, f)


class Side:
    """``fn(*args)`` (a module-level function) in a process of its own (start method
    spawn, TF32 off) beside the phases that follow it on the same card and host;
    ``result()`` waits for it and returns its value, ``stop()`` ends it where those
    phases failed."""

    def __init__(self, fn, *args):
        import multiprocessing

        self.name = fn.__name__
        self.path = os.path.join(WORK, f"side_{self.name}.pkl")
        self.process = multiprocessing.get_context("spawn").Process(
            target=_side_main, args=(fn, self.path, args))
        self.process.start()

    def result(self):
        import pickle

        self.process.join()
        check(self.process.exitcode == 0, f"{self.name} exited with {self.process.exitcode}")
        with open(self.path, "rb") as f:
            return pickle.load(f)

    def stop(self):
        self.process.terminate()
        self.process.join()


def v3_unet_facenet_phases(card, files):
    """Phases 15-17 (the YOLOv3 family), 19 (UNet) and 21 (FaceNet), run beside
    phases 12-14."""
    v3_weights = timed(15, card, phase_v3_slice, card)
    v3 = (timed(16, card, phase_v3_serving, card, v3_weights),
          timed(17, card, phase_v3_train, card, files, v3_weights))
    timed(19, card, phase_unet, card)
    timed(21, card, phase_facenet, card)
    return v3


def export_phase(card, weights, d0_weights):
    """Phase 24 (the serving artifacts), run beside phases 18, 20 and 22."""
    return timed(24, card, phase_export, card, weights, d0_weights)


def timed(number, card, fn, *args):
    """``fn(*args)``, then ``phase N took X s`` on a line of its own."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"phase {number} took {time.perf_counter() - t0:.1f} s on [{card}]", flush=True)
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing was run",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    t0 = time.perf_counter()
    card = phase_environment()
    print(f"phase 1 took {time.perf_counter() - t0:.1f} s on [{card}]", flush=True)
    os.makedirs(WORK, exist_ok=True)
    timed(2, card, phase_build, card)
    nms_err, nms_times, nms_device, nms_bound = timed(3, card, phase_kernel, card)
    model_f32, weights = timed(4, card, phase_slice, card)
    model, yolo_launches, served_p50 = timed(5, card, phase_serving, card, weights)
    timed(6, card, phase_numbers, card, model, model_f32, served_p50)
    del model, model_f32
    dw_err, dw_sums = timed(7, card, phase_dw_kernel, card)
    d0_weights = timed(8, card, phase_d0_slice, card)
    d0_launches, d0_served_p50 = timed(9, card, phase_d0_serving, card, d0_weights)
    timed(10, card, phase_d0_numbers, card, d0_weights, d0_served_p50)
    files = write_train_set(os.path.join(WORK, "train_set"))
    train = timed(11, card, phase_train, card, files)
    side = Side(v3_unet_facenet_phases, card, files)
    try:
        eval_launches = timed(12, card, phase_eval, card, files, train["ckpt"])
        d0_train = timed(13, card, phase_d0_train, card, files)
        d0_eval = timed(14, card, phase_d0_eval, card, files, d0_train["ckpt"], d0_weights)
        v3_serving, v3_train = side.result()
    except BaseException:
        side.stop()
        raise
    export = Side(export_phase, card, weights, d0_weights)
    try:
        mosaic = timed(18, card, phase_mosaic_train, card, files)
        extras = timed(20, card, phase_serving_extras, card, files, mosaic, d0_train["ckpt"])
        distill = timed(22, card, lambda: (phase_moco(card, files),
                                           phase_distill(card, files))[1])
        exported = export.result()
    except BaseException:
        export.stop()
        raise
    # the kernels' and the parallel paths' readings: the card and host to themselves
    int8 = timed(23, card, phase_int8, card, weights, files, train["ckpt"], d0_train["ckpt"])
    parallel = timed(25, card, phase_parallel, card, files, weights, d0_weights)
    spatial = timed(26, card, phase_spatial, card, files, weights, d0_weights, parallel)
    dp_launches, sp_launches = parallel["launches"], spatial["launches"]
    nms_launches = (yolo_launches["nms_sweep"] + d0_launches["nms_sweep"]
                    + train["val_launches"] + eval_launches + d0_eval["nms_sweep"]
                    + v3_serving["launches"] + v3_train["launches"] + mosaic["val_launches"]
                    + extras["nms_sweep"] + distill["launches"] + exported["nms_sweep"]
                    + dp_launches["nms_sweep"] + sp_launches["nms_sweep"])
    dw_launches = (d0_launches["dwconv_bn_swish"] + d0_eval["dwconv_bn_swish"]
                   + extras["dwconv_bn_swish"] + exported["dwconv_bn_swish"]
                   + dp_launches["dwconv_bn_swish"] + sp_launches["dwconv_bn_swish"])
    int8["launches"]["int8_conv"] += (exported["int8_conv"] + dp_launches["int8_conv"]
                                      + sp_launches["int8_conv"])
    int8["max_err"]["int8_conv"] = max(int8["max_err"]["int8_conv"], spatial["int8_err"])
    dw = dw_sums[64]
    i8, i8dw = int8["int8_conv"], int8["int8_dwconv"]
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s on [{card}]; kernels "
          f"line: nms_sweep at N=1024 B=1 (ms: device time by CUDA graph, mask + scan "
          f"kernels), launches over the served paths (YOLOv4 "
          f"{yolo_launches['nms_sweep']}, D0 {d0_launches['nms_sweep']}, YOLOv3 "
          f"{v3_serving['launches']}), the YOLOv4 trainer's val passes "
          f"({train['val_launches']}), the YOLOv4 eval CLI ({eval_launches}), the D0 eval CLI "
          f"({d0_eval['nms_sweep']}), the YOLOv3 trainer's val passes ({v3_train['val']}), the "
          f"YOLOv3 eval CLI ({v3_train['eval']}) and the YOLOv3 server on the trained "
          f"checkpoint ({v3_train['serve']}), the YOLOv4 @608 mosaic trainer's val passes "
          f"({mosaic['val_launches']}), the WSGI apps and detect CLI of phase 20 "
          f"({extras['nms_sweep']}) and phase 22's pseudo-labeler (dump_labels "
          f"{distill['dump']}, train_students {distill['students']}); dwconv_bn_swish "
          f"summed over the 16 launches of one D0 bf16 forward at B=64, launches over the D0 "
          f"served path ({d0_launches['dwconv_bn_swish']}), the D0 eval CLI "
          f"({d0_eval['dwconv_bn_swish']}) and phase 20's D0 WSGI app and detect CLI "
          f"({extras['dwconv_bn_swish']}); int8_conv summed over the 107 calls of one "
          f"YOLOv4 @640 b16 bf16 per-channel forward (each the quantize pass, "
          f"{i8['quantize_ms']:.4f} ms of the sum, and the GEMM), calls over phase 23's served "
          f"paths and eval CLIs; int8_dwconv summed over the {i8dw['launches']} launches of one D0 "
          f"@512 b64 bf16 forward, launches in the D0 int8 eval CLI; their library_ms the "
          f"quantize + int8 im2col + torch._int_mm + dequant route (cuDNN f32 grouped conv of the "
          f"int8 values for the depthwise), cuDNN bf16 of the same convs {i8['cudnn_ms']:.4f} "
          f"and {i8dw['cudnn_ms']:.4f} ms; phase 24's served artifacts add nms_sweep "
          f"{exported['nms_sweep']}, dwconv_bn_swish {exported['dwconv_bn_swish']} and "
          f"int8_conv {exported['int8_conv']} launches, phase 25's data-parallel paths (the "
          f"--dp trainer's val pass, the --fsdp checkpoint served and scored, serve --dp) "
          f"nms_sweep {dp_launches['nms_sweep']}, dwconv_bn_swish "
          f"{dp_launches['dwconv_bn_swish']} and int8_conv {dp_launches['int8_conv']}, and "
          f"phase 26's height-sharded servers (serve --spatial 2: YOLOv4, its int8 twin, D0) "
          f"nms_sweep {sp_launches['nms_sweep']}, dwconv_bn_swish "
          f"{sp_launches['dwconv_bn_swish']} and int8_conv {sp_launches['int8_conv']}",
          flush=True)
    print(json.dumps({"kernels": [
        {"name": "nms_sweep", "route": "cuda", "source": NMS_SOURCE, "replaces": NMS_REPLACES,
         "launches": nms_launches,
         "max_abs_err": nms_err, "ms": nms_device[1]["sweep"], "plain_ms": nms_times[1][1],
         "bound_ms": nms_bound[0], "bound_by": nms_bound[1], "library_ms": None},
        {"name": "dwconv_bn_swish", "route": "cuda", "source": DW_SOURCE,
         "replaces": DW_REPLACES, "launches": dw_launches,
         "max_abs_err": dw_err, "ms": dw["ms"], "plain_ms": dw["plain_ms"],
         "bound_ms": dw["bound_ms"], "bound_by": max(dw["by"], key=dw["by"].get),
         "library_ms": dw["library_ms"]},
        {"name": "int8_conv", "route": "cuda", "source": INT8_SOURCE, "replaces": INT8_REPLACES,
         "launches": int8["launches"]["int8_conv"], "max_abs_err": int8["max_err"]["int8_conv"],
         "ms": i8["ms"], "plain_ms": i8["plain_ms"], "bound_ms": i8["bound_ms"],
         "bound_by": max(i8["by"], key=i8["by"].get), "library_ms": i8["library_ms"]},
        {"name": "int8_dwconv", "route": "cuda", "source": INT8_SOURCE,
         "replaces": INT8_REPLACES, "launches": int8["launches"]["int8_dwconv"],
         "max_abs_err": int8["max_err"]["int8_dwconv"], "ms": i8dw["ms"],
         "plain_ms": i8dw["plain_ms"], "bound_ms": i8dw["bound_ms"],
         "bound_by": max(i8dw["by"], key=i8dw["by"].get), "library_ms": i8dw["library_ms"]},
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
