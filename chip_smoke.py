#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py          # from the repository root, one CUDA card

It builds the four hand-written CUDA kernels (nvcc, sm_90a) and drives two
models at full width in bf16 with seeded random weights, each in inference
on the bench batch (batch 4, 16000-voxel cap with 14000 filled from
ray-cast surface scans, host rulebooks, 18000 raw points per scan; MGAF
reads no points) and in training (below).

  * FV2P (tools/cfgs/kitti_models/FV2P/fv2p.yaml), KITTI Car: all four
    kernels on its path;
  * MGAF-3DSSD (tools/cfgs/kitti_models/MGAF-3DSSD/mgaf-3dssd.yaml), KITTI
    Car: the DCN BEV backbone and CenterAF head, kernel B1 in its final NMS
    (one launch per scan).

For each model it

  * sets the kernels' launch counters to 0 just before one forward, reads
    them just after, and checks each kernel of the path launched (and, for
    MGAF, B1 exactly once per scan, the sparse conv once per trunk conv,
    and nothing else);
  * replays every kernel call the forward made, kernel against its plain
    PyTorch version on the same card tensors (B2/B3 indices identical, B3
    squared distances within rtol 1e-6 + atol 1e-6, B1 IoU and areas within
    1e-4 and exactly 0.0 where the kernel's cull applies, NMS keep lists
    identical, B4 within 2^-7 of max(|ref|, 2^-3) element by element: a
    sound kernel differs by at most one bf16 ulp);
  * runs the forward once more in f32 (no TF32) with the kernels and once
    with the plain versions, and compares the detections;

then holds all four kernels against their plain versions on small seeded
corner cases (rows without valid points, ties, ball counts at and around
nsample, unsorted sources, touching, degenerate and negative-extent boxes,
ragged sizes, B2 at 24000 points with an invalid tail and at its 24576
limit), with the same comparisons. Then the times, all before any use
of torch.profiler: each kernel's calls of one FV2P forward with CUDA events
beside its plain version, the least time the card could take for the same
work, (B3) torch.cdist + topk as a library yardstick and the least share of
tiles an exact tile-pruned search must visit, (B2) the kernel's chain of
cluster exchanges without its distance work, (B1) the share of pairs that
survive the cull, and B1 on MGAF's calls; all deformable convolutions of one
MGAF forward beside their bound; each model's whole forward on the batch
already on the card (median of 10), per module, and its peak memory. Last,
under the profiler and CUDA's sync debug mode: the device's busy share of one
pass of each model, each kernel's own device time, the kernels one IoU call
queues, and the calls in one forward that make the host wait for the card,
by source line.

The sparse conv kernel (ops/csrc/sparse_conv.cu, the trunk's no-grad
forward) is timed after the whole forwards, on the 21 convs of one batch
at fv2p_kitti_infer's shape (batch 4, the 40000-voxel test cap): each call
held to its plain version, then the kernel, the plain version and the
parent's gather + torch.matmul beside the bound; its device time under the
profiler comes last. The record is `sparse_conv` in chip_smoke.json.

Training comes after the timed forwards and before the profiler: FV2P in
train mode at full width (batch 2, the 16000-voxel train cap with 14000
filled, the rulebooks at the yaml's train level capacities
(MODEL.BACKBONE_3D.LEVEL_CAPACITIES, as tools/train.py passes them), each
scan padded to the config's 24000-point cap, the six simulated cars of each
scan as gt, bf16 compute and f32 parameters, adam_onecycle over 1000
steps). First one f32 step (no TF32) through the kernels and through
the plain versions from the same weights and generators: FPS picks and
proposal-NMS keeps identical, loss terms within 1e-5 relative, every
gradient within 1e-4 max|g| + 1e-7 (the biases a train-mode BatchNorm
normalises away, whose true gradient is 0, as noise on both sides). Then 2
warm-up and 5 timed bf16 steps, each counted (B1, B2 and B3 launch on
every step, B4 never: training groups without it), with CUDA events around
forward+loss, backward and the optimizer step, every loss term finite; one
more step whose kernel calls are held against the plain versions and timed
(B2 beside its chain floor at 24000 points); last, under the sync debug
mode and the profiler, the host waits and the card's busy share of a step.
The train record goes to chiprun_out/chip_smoke.json under `train`, and the
`kernels` line gives each kernel's train-path launches beside the eval ones.

Then MGAF-3DSSD in train mode at full width, the same way: batch 4
(mgaf-3dssd.yaml's BATCH_SIZE_PER_GPU), its yaml's train level capacities,
no raw points, the six cars of each scan as gt, adam_onecycle over 1000
steps. The f32 step through the kernels and through the plain versions
must give identical iou-score targets (B1's use on this path), loss terms
within 1e-5 relative and gradients within 1e-4 max|g| + 1e-7; in the 2 + 5
bf16 steps B1 launches on every step and no other kernel does, every loss
term is finite, and the first step has object centers and foreground
cells among its targets; B1's calls of one more step are held against the
plain version and timed; last, the step's four deformable convolutions are
replayed, forward and forward + backward, beside their bounds. The record
is `mgaf_train` in chip_smoke.json, the `mgaf_train_*` keys of the
`kernels` line.

Then the runners on the committed KITTI fixture (data/kitti; the script
fails without it), between FV2P's training and MGAF's:

  * kitti_eval: fv2p_torch.tools.eval_utils.eval_one_epoch over the 24 val
    scans, fv2p.yaml at the 40000-voxel test cap with 24000-point scans,
    bf16, batch 4 (6 batches), 4 spawned loader workers, seeded weights.
    The first run is counted (all four kernels launch) and every kernel
    call captured: B1's calls (NMS, the recall counter, the evaluator) and
    the first batch's calls of B2-B4 are held against the plain versions
    and timed (`kitti_eval_*` keys of the `kernels` line). The second run
    gives the seconds per scan (the first batch apart), the loader's wait
    per batch, the forward's median, voxels and points per scan, recall and
    AP (near 0: seeded weights). One batch in f32 through the kernels and
    through the plain versions must give the same det_annos (names exact,
    floats within 1e-5) and recall counts. MGAF-3DSSD's eval goes through
    the same runner (BatchNorm calibrated on the first batch; B1 only).
  * kitti_evaluator: the val ground truth scored against itself on the
    card: Car 3D AP_R40 must be 100 for moderate and hard and, with 32 easy
    cars, 100 (32 - 1) / 40 = 77.5 for easy (the official 41-point
    sampling); and kitti_eval's AP dict must be the same with B1's plain
    version on the CPU, key for key.
  * kitti_train: fv2p_torch.tools.train on the 32 train scans (fv2p.yaml,
    bf16, batch 2, full augmentation with gt sampling, the yaml's train
    level caps, 4 spawned workers, a tenth of the yaml's peak learning rate:
    at 0.01 the two-epoch schedule overflows): one epoch and its checkpoint, then the
    runner again for two epochs with --max_ckpt_save_num 1, which must
    resume with the saved parameters, optimizer state and one-cycle step
    bit for bit and leave one checkpoint; every loss term finite; the step
    through the runner (loader wait included), the loader's wait, and the
    host seconds a batch with the C++ and the numpy rulebook builders. Its
    checkpoints go to output/chip_smoke/.

Then, after MGAF's training, the phases of device-built rulebooks and of
SECOND and PointPillar:

  * device_rulebooks: FV2P and MGAF-3DSSD on the bench batch as the loader
    ships it with --rulebooks device (each scan's voxels shuffled, no
    tables). Every level's rows per sample and the device tables, mapped
    to per-sample rows, must equal the host builder's, with nothing
    dropped; the f32 forward from the same weights must give the same
    detections in both modes (keeps and labels identical; boxes and scores
    within 1e-4 for FV2P, for MGAF within CONTROL_FACTOR times what a 1e-6
    relative perturbation of its BEV map moves them in host mode alone,
    since its DCNs swap neighbouring peaks within rounding); B3's batch-mixed calls (each sample's search over the
    level four samples wide, the other samples' rows masked) are held to
    the plain version and timed beside cdist + topk in query chunks
    (`device_rulebooks_*` keys of the `kernels` line). The builder's time
    a forward, its host waits under the sync debug mode (there must be
    none), and later under the profiler the kernels it queues; the bf16
    forwards of both models in device mode and their peak memory.
  * second and pointpillar: kitti_models/second.yaml and pointpillar.yaml
    at full width in bf16, batch 4, BatchNorm calibrated on the batch
    (seeded weights put no anchor over SCORE_THRESH otherwise): SECOND on
    the bench voxels (its backbone builds its rulebooks in the forward),
    PointPillar on pillars of the same scans' raw points through the
    port's voxel generator (40000-pillar test cap). Counted (B1 in the NMS,
    no other kernel), B1's calls held to the plain version and timed
    (`second_*`, `pointpillar_*` keys), the f32 forward through the
    kernels against the plain versions, the forward's median, per-module
    times, peak memory and host waits; then an f32 train step through the
    kernels and through the plain versions (as FV2P's), and 2 + 5 bf16
    steps at the yaml's batch 4 (adam_onecycle), every loss term finite and
    the loss falling.
  * kitti_eval_device: eval_one_epoch over data/kitti's val scans with
    --rulebooks device, the kitti_eval model. The first run is counted as
    kitti_eval's (every kernel launches), B3's batch-mixed calls at the
    test cap and B1's calls held to the plain versions and timed
    (`kitti_eval_device_*` keys); the second's AP dict must equal host
    mode's, and one batch in f32 must give host mode's detections within
    KITTI_F32_ATOL; the loader's wait and seconds a scan beside host mode's.
  * kitti_second: fv2p_torch.tools.train for one epoch of second.yaml on
    the 32 train scans (Car and Pedestrian: the fixture has no Cyclist;
    fv2p.yaml's train level capacities, which second.yaml does not set:
    its derived ones drop rows under gt sampling), then
    fv2p_torch.tools.test on its checkpoint, each counted (training
    launches no kernel; the test run B1 alone, its calls held to the plain
    version, `kitti_second_*` keys); the step median and the loader's
    wait.
  * second_multihead: kitti_models/second_multihead.yaml (the multihead
    anchor head with 1x1 heads, one NMS lane a class) as second above.

Then the multihead models of nuScenes on the committed fixture
(data/nuscenes; the script fails without it), each as second above but on
the fixture's scans through NuScenesDataset: the eval batch is 4 scans in
test mode (the 2 val scans, then train scans), the train batch the first 4
samples of the CBGS-resampled train split with gt sampling. A sparse trunk
gets host rulebooks at capacities measured on the batch's own scans (the
most rows a level holds, times CAP_MARGIN), each printed beside the
occupancy; the gt rows past MAX_GT_BOXES are counted; the anchors above
SCORE_THRESH are counted per (scan, class) NMS lane.

  * nuscenes: nuscenes_models/cbgs_second_multihead.yaml, the 1024 x 1024
    x 40 grid, 10 classes, 6 heads with separate regression, 9-dim boxes.
  * nuscenes_pp: nuscenes_models/cbgs_pp_multihead.yaml on pillars of the
    same scans (its first BEV level downsampled by a strided conv).
  * nuscenes_runner: fv2p_torch.tools.train for 20 epochs of 10 steps of
    cbgs_second_multihead_overfit.yaml (the yaml's LEVEL_CAPACITIES, device
    rulebooks, nothing dropped; no kernel launches; after one epoch the eval-mode BatchNorm statistics
    still lag and the decoded boxes overflow), then fv2p_torch.tools.test
    on its checkpoint with the native evaluator (mAP and NDS finite; B1
    alone, its calls held to the plain version, `nuscenes_runner_*` keys);
    then one train epoch
    with --rulebooks device at NUSC_SMALL_CAPS, which must raise within
    train.LOG_INTERVAL steps of its first dropped row and write no
    checkpoint.

Then the RoI-grid models, after the nuScenes phases:

  * pv_rcnn: kitti_models/pv_rcnn.yaml at full width in bf16, batch 4, on
    the bench batch (voxels and each scan's 18000 raw points; the backbone
    builds its rulebooks in the forward), BatchNorm calibrated on the
    batch. Counted: B2 once a forward (2048 keypoints), B1 at least twice a
    scan (proposal NMS 1024 -> 100 at 0.7, final NMS), B3 and B4 never;
    every call held to its plain version and timed (`pv_rcnn_*` keys), the
    proposal and final NMS keeps identical on both routes, the f32 forward
    through the kernels against the plain versions; the forward's median,
    per module and VSA by part (FPS, each source's grouping), peak memory,
    host waits, and each ball-query call alone: its time, its temporaries
    (at most BALL_QUERY_GIB) and its share of non-empty balls. Then train
    steps at the yaml's batch 4 on 24000-point scans with the six cars of
    each scan (B2's 24576-point instantiation): an f32 step through the
    kernels and through the plain versions (FPS picks, proposal keeps and
    sampled RoIs identical; loss terms and gradients as FV2P's), 2 + 5 bf16
    steps (B2 once and B1 on every step, every loss term finite, no rows
    dropped), one more with each ball-query call alone (at most
    BALL_QUERY_GIB), one more whose calls are held to the plain versions
    (`pv_rcnn_train_*` keys).
  * voxel_rcnn: kitti_models/voxel_rcnn/voxel_rcnn_car.yaml the same way:
    B1 only, the grid's ball queries over x_conv3 and x_conv4 timed alone.
  * kitti_pv_rcnn: fv2p_torch.tools.train for one epoch of pv_rcnn_car.yaml
    on data/kitti (8 steps at batch 4, --rulebooks device at fv2p.yaml's
    train level capacities, the peak learning rate at KITTI_TRAIN_LR),
    then fv2p_torch.tools.test on its checkpoint over the 24 val scans;
    both counted (B1 and B2), the test run's calls held to the plain
    versions (`kitti_pv_rcnn_*` keys), the AP dict produced.

Then Waymo, on the committed fixture (data/waymo: 3 sequences of 2 frames,
30000 points each; the script fails without it), after the RoI-grid phases:

  * waymo_fv2p: tools/cfgs/waymo_models/FV2P/waymo_fv2p_e30.yaml at full
    width in bf16, batch 2 (its BATCH_SIZE_PER_GPU): the 2 val frames
    through the port's WaymoDataset in test mode (180000-point scans, the
    90000-voxel test cap, host rulebooks at the yaml's level capacities on
    the 1504 x 1504 x 41 grid), seeded weights. Counted (all four kernels;
    B2 once, on its 180000-point instantiation, 16384 picks), every call
    held to its plain version and timed (`waymo_fv2p_*` keys; B2 beside its
    chain floor), NMS keeps identical, the f32 forward through the kernels
    against the plain versions, the forward's median of 10, per module and
    peak memory. Then 2 train samples (gt sampling, flips, rotation,
    scaling; the 80000-voxel train cap): an f32 step through the kernels and
    through the plain versions (as FV2P's KITTI step), and 2 + 5 bf16 steps
    (B1, B2, B3 each step, every loss term finite, no level over its
    capacity).
  * waymo_pv_rcnn: tools/cfgs/waymo_models/pv_rcnn.yaml, one bf16 forward
    on the same frames (device rulebooks at waymo_fv2p_e30.yaml's level
    capacities: the yaml sets none and its derived ones drop rows; nothing
    dropped), BatchNorm calibrated: B2 (4096 keypoints from 180000 points) and B1 counted and
    held to their plain versions (`waymo_pv_rcnn_*` keys), NMS keeps
    identical, each ball-query call alone within BALL_QUERY_GIB.
  * waymo_runner: the gate fixture written into output/ by
    ``python -m fv2p_torch.tools.make_synthetic_waymo``; the train runner
    for WAYMO_RUNNER_EPOCHS epochs of waymo_mgaf-3dssd_overfit.yaml on it,
    then the test runner with the native Waymo metrics (Vehicle L1/L2 AP
    and APH); one train epoch of waymo_fv2p_e30.yaml on data/waymo and the
    test runner with the KITTI-format metric. Launches counted, the test
    runs' kernel calls held to the plain versions (`waymo_runner_*` keys).

B2's corner cases (8.) include 180000-point scans: a mask that is no
prefix, a row without a valid point, fewer valid points than picks, and
the kernel's limit of 180224.

Then PointRCNN on data/kitti after the Waymo phases:

  * kitti_pointrcnn: kitti_models/pointrcnn.yaml at full width on the first
    4 val scans through KittiDataset (16384 sampled points a scan), seeded
    weights, BatchNorm calibrated (the point modules compute in f32, as
    JAX's, whatever the runner's dtype). Counted: B2 six times (the
    backbone's 4096 / 1024 / 256 / 64 picks, the RoI head's 128 of 512 and
    32 of 128 in each of 400 RoI rows), B3 at the four FP levels, B1 at
    least twice a scan; each call site held to the plain versions and
    timed (`kitti_pointrcnn_{backbone,head,nms}_*` keys), NMS keeps
    identical, the f32 forward through the kernels against the plain
    versions, the forward's median, per module, peak memory, the head's B2
    share of the forward, each backbone ball query alone.
  * kitti_pointrcnn_train: 2 + 5 bf16 train steps of pointrcnn.yaml (Car
    and Pedestrian: the fixture's classes) on 4 train samples with gt
    sampling, jittered gt boxes among the proposals so that the RCNN
    regression trains (above 0 every step), one more step's calls held to
    the plain versions by call
    site (the head's B2 on 512 rows; `kitti_pointrcnn_train_*` keys), one
    step of pointrcnn_iou_car.yaml, and fv2p_torch.tools.test over the 24
    val scans (`kitti_pointrcnn_test_*` keys), AP finite.

Then the PartA2 family, and last data parallelism (ddp):

  * kitti_parta2: kitti_models/PartA2.yaml at full width on the first 4
    val scans of data/kitti (the 40000-voxel test cap, host tables), bf16,
    BatchNorm calibrated. Counted: B1 alone, at least twice a scan (the
    proposal NMS, 1024 -> 100 at 0.7, and the final NMS); every call held
    to the plain version and timed (`kitti_parta2_*` keys), NMS keeps
    identical, the f32 forward through the kernel against the plain
    version; the forward's median, per module, the RoI head by part
    (proposals, RoI-aware pooling, the dense conv stack, the FCs), peak
    memory, RoI-aware pooling alone beside its byte bound, host waits.
  * kitti_parta2_train: PartA2.yaml (Car and Pedestrian with their
    anchors; fv2p.yaml's train level capacities: the yaml sets none) on 4
    train samples with gt sampling, jittered gt boxes among the anchor
    head's proposals: an f32 step through the kernel and the plain version
    (proposal keeps and sampled RoIs identical, loss terms and gradients
    as FV2P's), 2 + 5 bf16 steps (foreground RoIs, the RCNN regression
    above 0 every step), the step per module, one more step's calls held to
    the plain version (`kitti_parta2_train_*` keys); one step each of
    PartA2_car.yaml and PartA2_free.yaml; fv2p_torch.tools.test over the
    24 val scans (`kitti_parta2_test_*` keys); the train runner on 4 train
    scans of PartA2_car.yaml with OPTIMIZER sgd and --profile_steps 2,3
    (the trace must hold CUDA kernel events) and with adam.
  * waymo_parta2: waymo_models/PartA2.yaml at full width on the 2 val
    frames of data/waymo (90000-voxel cap, waymo_fv2p_e30.yaml's level
    capacities), the same counts and comparisons as kitti_parta2, then one
    train step on 2 train samples (Vehicle and Pedestrian: the fixture has
    no Cyclist in its gt database).
  * second_atss (after the zoo phases): kitti_models/second.yaml with
    TARGET_ASSIGNER_CONFIG set to ATSSTargetAssigner (TOPK 9, MATCH_HEIGHT
    False) on `second`'s train batch (batch 4, the six cars of each scan):
    an f32 step through B1 and through its plain version (box_cls_labels,
    regression targets and weights identical, loss terms within 1e-5
    relative, gradients within 1e-4 max|g| + 1e-7), 2 + 5 bf16 steps (B1
    every step: one (211200, 50) IoU a scan; positive anchors in every
    scan), one more step's B1 calls held to the plain version and timed
    (`second_atss_*` keys), one step with MATCH_HEIGHT True (3-D IoU).
  * demo: fv2p_torch.tools.demo.main in this process on fv2p.yaml with
    data/kitti's first val scan (000032) and kitti_train's checkpoint, at
    batch 1 with the sparse tables built on the card: counted (B1-B4 each
    launch), the same forward captured and every call held to the plain
    version and timed (`demo_*` keys), the forward's median, an f32 forward
    through the kernels and through the plain versions (the same
    detections); then the default invocation (MGAF-3DSSD on the synthetic
    scan, seeded weights), counted. Each run's host set-up seconds and
    forward ms are recorded.
  * ddp: (a) torchrun --nproc_per_node 1 -m fv2p_torch.tools.train --dist
    (NCCL) against the same run without --dist, both under deterministic
    algorithms, loss terms by step; DDP's cost a step at one rank. (b) two
    gloo ranks on the card, one f32 FV2P train step at global batch 4
    against this process computing the two halves in turn and averaging
    them: gradients, updated parameters and averaged running statistics.
    (c) the test runner in two gloo ranks against one rank: merged
    detections in dataset order, recall and AP. The card is one, so NCCL
    at more than one rank is not checked.

Depths, cut so that the Waymo phases fit: forwards are timed as the median
of 10 (FORWARD_REPS; 20 before), train steps as 2 + 5 (TRAIN_TIMED; 2 + 10
before), each kernel's plain version is timed in the run that compares it
(not once more), and the runs of a few batches after the KITTI runner
phases (kitti_second, the nuScenes test run, kitti_pv_rcnn, waymo_runner)
load in the main process (SHORT_RUN_WORKERS). No path, comparison or count
of launches was dropped. The whole script took 565 s on an H100 (819 s with
the Waymo phases before those cuts), and 783 s with the PointRCNN and ddp
phases (~160 s of it) on a slower host, against a time limit of 1200 s; the
PartA2 phases add ~70 s. The seconds of each phase are printed at the end
(`phase_s` in chip_smoke.json).

Exits non-zero on any failure, and without a CUDA card. The second-to-last
lines are a JSON ``kernels`` object (FV2P's path) and the nvidia-smi name and
power limit; the last line is ``{"ok": true, "device": {...}}``. A fuller
record, MGAF's numbers included, goes to chiprun_out/chip_smoke.json.
"""
import contextlib
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
CFG = REPO / 'tools' / 'cfgs' / 'kitti_models' / 'FV2P' / 'fv2p.yaml'
MGAF_CFG = REPO / 'tools' / 'cfgs' / 'kitti_models' / 'MGAF-3DSSD' / 'mgaf-3dssd.yaml'
OUT_DIR = REPO / 'chiprun_out'
BATCH, N_CAP, N_FILL, N_POINTS, SEED = 4, 16000, 14000, 18000, 0
# training (fv2p.yaml OPTIMIZATION and DATA_CONFIG): batch 2 a card, scans
# padded to MAX_POINTS_PER_SCAN, adam_onecycle over 1000 steps as
# tools/bench_train.py schedules it
TRAIN_BATCH, TRAIN_POINTS, TRAIN_TOTAL_STEPS = 2, 24000, 1000
TRAIN_WARMUP, TRAIN_TIMED = 2, 5
# the KITTI runner phases: the committed fixture, the runners' batch sizes
# (eval 4 as the bench, train fv2p.yaml's 2) and spawned loader workers
KITTI = REPO / 'data' / 'kitti'
KITTI_BATCH, KITTI_TRAIN_BATCH, KITTI_WORKERS = 4, 2, 4
# the runs of a few batches after the KITTI runner phases (kitti_second,
# the nuScenes test run, kitti_pv_rcnn, waymo_runner) load in the main
# process: a set of spawned workers took 10-30 s to start on the card's
# host, longer than those runs' own data
SHORT_RUN_WORKERS = 0
KITTI_F32_ATOL = 1e-5
KITTI_TRAIN_LR = 0.001          # fv2p.yaml's LR is 0.01

# H100 SXM data sheet (dense): HBM rate, f32 outside the tensor cores, bf16
HBM_BYTES_S, F32_OPS_S, BF16_OPS_S = 3.35e12, 67e12, 989e12
# the sparse conv kernel (ops/csrc/sparse_conv.cu): VoxelResBackBone8x's
# convs a forward, timed on fv2p_kitti_infer's batch (the 40000-voxel test
# cap with N_FILL voxels a scan, derived level caps, host tables)
SPARSE_TRUNK_CONVS = 21
# the DCN kernel (ops/csrc/dcn.cu): MGAF-3DSSD's deformable convs a forward
# (three in the BEV backbone's deblocks, one in the head)
MGAF_DCN_CALLS = 4
SC_N_CAP = 40000
# kernel against plain: the same exact products summed in another f32
# order (at most ~n 2^-24 of the sum of |terms|, n <= 27 * 128), then one
# bf16 rounding each (one ulp apart at most, <= 2^-7 |v|)
SC_REL, SC_SUM_REL = 2.0 ** -7, 2.0 ** -12
# Sutherland-Hodgman over 4 edges x 8 slots + the shoelace sum (clip_area)
CLIP_OPS_PER_PAIR = 460
B1_ATOL = 1e-4              # m^2 of area; of max(1, |IoU|) for the IoU
# the cull of rotated_iou.cu, repeated here in tensor code
B1_CULL_REL, B1_CULL_ABS, B1_MIN_EDGE_REL = 1e-3, 1e-5, 1e-4
# B4 rounds its f32 sums to bf16 (8 significant bits) as the plain version
# does; another order of summation moves an output by one ulp at most, and
# one ulp of v is at most 2^-7 |v|. Below 2^-3 the allowance stays 2^-10.
B4_REL, B4_FLOOR = 2.0 ** -7, 2.0 ** -3
B3_DIST_TOL = 1e-6          # rtol and atol (m^2): both sides round alike
F32_ATOL = 1e-4
# MGAF's f32 detections, host against device tables: at most this many
# times what a 1e-6 relative perturbation of the BEV map moves them
CONTROL_FACTOR = 2.0
FORWARD_REPS = 10
MODULE_REPS = 3
KEPT_ROWS = 100             # the kept buffer of the proposal NMS (post_max)
# finite outputs each model must give besides the detections
FV2P_KEYS = ('batch_box_preds', 'batch_iouscore_preds', 'point_features')
MGAF_KEYS = ('batch_box_preds', 'batch_iouscore_preds', 'spatial_features_before_head')


def log(*a):
    print(*a, flush=True)


def fail(msg):
    log(f'FAIL: {msg}')
    sys.exit(1)


def sync():
    torch.cuda.synchronize()


def time_events(fn, reps, warmup=1):
    """Mean ms of fn() over reps runs, CUDA events around the whole loop."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    sync()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps=5):
    """Mean ms the card is busy in one fn(): the kernels' and copies' own
    durations under torch.profiler. Unlike events around the calls, this
    leaves out the gaps in which the card waits for the host to queue, which
    decide the event time of a few short launches. A profile that records
    no device time at all is taken again, up to twice: some profiles of the
    same calls that others time at 0.1-7 ms have come back empty."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    sync()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            sync()
        busy_us = sum(e.device_time for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA)
        if busy_us > 0:
            break
    return busy_us / 1e3 / reps


def clone_args(args):
    return tuple(a.clone() if torch.is_tensor(a) else a for a in args)


class Kernel:
    """One kernel: its wrapper module, its entry points ({CUDA function:
    plain function}), the TPU kernel it replaces, and the calls the main
    path made to it, each a pair (CUDA function, arguments)."""

    def __init__(self, name, module, entries, source, replaces):
        self.name, self.module, self.entries = name, module, entries
        self.source, self.replaces = source, replaces
        self.calls = []
        self.plain_ms = None     # set by compare() over the calls

    def launch(self, call):
        fn, args = call
        return getattr(self.module, fn)(*args)

    def plain(self, call):
        fn, args = call
        return getattr(self.module, self.entries[fn])(*args)


@contextlib.contextmanager
def patched(kernels, make):
    """Temporarily replace each CUDA entry point by make(k, name, orig)."""
    saved = [(k, fn, getattr(k.module, fn)) for k in kernels for fn in k.entries]
    for k, fn, orig in saved:
        setattr(k.module, fn, make(k, fn, orig))
    try:
        yield
    finally:
        for k, fn, orig in saved:
            setattr(k.module, fn, orig)


def copy_kernels(kernels):
    return [Kernel(k.name, k.module, k.entries, k.source, k.replaces) for k in kernels]


def capturing(k, name, orig):
    def fn(*args):
        k.calls.append((name, clone_args(args)))
        return orig(*args)
    return fn


def plain_route(k, name, _orig):
    return lambda *args: k.plain((name, args))


# ----------------------------------------------------------------- bounds

def bound_rotated_iou(call):
    """Every pair the function defines is clipped: all n x m, or i < j of a
    set against itself; boxes are 28 B, corners 32 B."""
    fn, args = call
    n, m = args[0].shape[0], args[-1].shape[0]
    upper = fn == 'iou_bev_upper_cuda'
    row = 32 if fn == 'overlap_matrix_cuda' else 28
    nbytes = (n if upper else n + m) * row + n * m * 4
    pairs = n * (n - 1) // 2 if upper else n * m
    return nbytes / HBM_BYTES_S, pairs * CLIP_OPS_PER_PAIR / F32_OPS_S


def bound_fps(call):
    pts, valid, k = call[1]
    b, n, _ = pts.shape
    nbytes = b * n * 13 + b * k * 4
    # each pick: 3 sub, 3 mul, 2 add, min, compare per valid point
    ops = 10 * (k - 1) * int(valid.sum())
    return nbytes / HBM_BYTES_S, ops / F32_OPS_S


def bound_three_nn(call):
    """The function by brute force, whatever implements it: a search that
    skips sources can come in under this."""
    src, valid, q = call[1]
    b, n, _ = src.shape
    m = q.shape[1]
    nbytes = b * n * 13 + b * m * 12 + b * m * 3 * 8
    ops = 10 * m * int(valid.sum())            # every valid source per query
    return nbytes / HBM_BYTES_S, ops / F32_OPS_S


def sa_slots(args):
    """Distinct MLP slots per (radius): max(1, min(in-ball count, nsample))."""
    centers, xyz, valid, _, _, _, _, _, radii, nsamples = args
    d2 = ((centers[:, :, None, :] - xyz[:, None, :, :]) ** 2).sum(-1)
    out = []
    for r, ns in zip(radii, nsamples):
        cnt = ((d2 < r * r) & valid[:, None, :]).sum(-1)
        out.append(int(cnt.clamp(min=1, max=ns).sum()))
    return out


def bound_sa_group(call):
    args = call[1]
    centers, xyz, valid, z, cw, w2, b1, b2, _, _ = args
    r, g, _ = centers.shape
    nbytes = sum(t.numel() * t.element_size()
                 for t in (centers, xyz, valid, z, cw, w2, b1, b2))
    nbytes += r * g * 128 * 2                   # bf16 output
    slots = sum(sa_slots(args))
    h = z.shape[-1]
    f32_ops = 8 * g * int(valid.sum()) + 2 * h * slots   # distances, layer 1
    bf16_ops = 2 * h * h * slots                         # layer 2
    return nbytes / HBM_BYTES_S, f32_ops / F32_OPS_S + bf16_ops / BF16_OPS_S


def bound_dcn(args):
    """One modulated_deform_conv call: its inputs read once (map, offsets,
    mask, weights) and its f32 output written once; 2 operations a MAC at
    the rate of the compute type."""
    x, dy, dx, mask, w, ks, _ = args
    b, h, wd, c = x.shape
    cout = w.shape[-1]
    nbytes = sum(t.numel() * t.element_size() for t in (x, dy, dx, mask, w))
    nbytes += b * h * wd * cout * 4
    macs = b * h * wd * ks * ks * c * cout
    rate = F32_OPS_S if x.dtype == torch.float32 else BF16_OPS_S
    return nbytes / HBM_BYTES_S, 2 * macs / rate, macs


# ------------------------------------------------------------ comparisons

def b1_sets(call):
    """(corners_a, corners_b, upper) of a rotated_iou call."""
    from fv2p_torch.ops.cuda.rotated_iou import bev_corners_ccw
    fn, args = call
    if fn == 'overlap_matrix_cuda':
        return args[0], args[1], False
    return bev_corners_ccw(args[0]), bev_corners_ccw(args[-1]), len(args) == 1


def b1_culled(call):
    """(N, M) bool: the pairs that the kernel's cull declares disjoint (the
    same test in tensor code: centers farther apart than the two radii with
    their margins, a box with a too short edge having an infinite radius,
    all finite)."""
    def circle(c):
        cen = c.mean(1)
        rad = (c - cen[:, None]).norm(dim=-1).amax(1)
        edge = (c.roll(-1, 1) - c).norm(dim=-1).amin(1)
        mag = cen.abs().sum(-1)
        return cen, mag, torch.where(edge > B1_MIN_EDGE_REL * (mag + rad), rad,
                                     float('inf'))

    ca, cb, _ = b1_sets(call)
    (cen_a, mag_a, rad_a), (cen_b, mag_b, rad_b) = circle(ca), circle(cb)
    d2 = ((cen_a[:, None] - cen_b[None]) ** 2).sum(-1)
    reach = ((rad_a[:, None] + rad_b[None]) * (1 + B1_CULL_REL)
             + B1_CULL_ABS * (mag_a[:, None] + mag_b[None]))
    return (d2 > reach ** 2) & torch.isfinite(d2)


def b1_survivors(call):
    """(pairs the kernel clips, pairs the function defines)."""
    culled = b1_culled(call)
    n, m = culled.shape
    if b1_sets(call)[2]:
        return int(torch.triu(~culled, diagonal=1).sum()), n * (n - 1) // 2
    return int((~culled).sum()), n * m


def b3_tiles_needed(call, d3, rows):
    """(needed, seeded, all) (query, tile) pairs of a three_nn call. A tile
    of `rows` consecutive sources is needed if its lower bound (the query's
    distance to the box of the tile's valid rows, at most 1e10 where the
    tile holds an invalid row) does not exceed the query's final third-best
    distance d3 (B, M): no exact search that skips whole tiles can visit
    fewer. It is seeded if its bound does not exceed the third-best distance
    within the tile of least bound, the kernel's first limit: the kernel
    visits at most these (it tightens the limit as it goes)."""
    src, valid, q = call[1]
    b, n, _ = src.shape
    tiles = -(-n // rows)
    pad = tiles * rows - n
    s = torch.nn.functional.pad(src, (0, 0, 0, pad)).view(b, tiles, rows, 3)
    real = torch.arange(tiles * rows, device=src.device).view(tiles, rows) < n
    ok = torch.nn.functional.pad(valid, (0, pad)).view(b, tiles, rows)
    lo = torch.where(ok[..., None], s, float('inf')).amin(2)[:, None]
    hi = torch.where(ok[..., None], s, float('-inf')).amax(2)[:, None]
    cap = torch.where((~ok & real).any(2), 1e10, float('inf'))[:, None]
    d = q[:, :, None] - torch.minimum(torch.maximum(q[:, :, None], lo), hi)
    bound = torch.minimum((d[..., 0] ** 2 + d[..., 1] ** 2) + d[..., 2] ** 2, cap)
    best = bound.argmin(-1)                                      # (B, M)
    sample = torch.arange(b, device=src.device)[:, None]
    offset = torch.where(ok, 0.0, 1e10).masked_fill(~real, float('inf'))
    e = q[:, :, None] - s[sample, best]                          # (B, M, rows, 3)
    in_best = ((e[..., 0] ** 2 + e[..., 1] ** 2) + e[..., 2] ** 2) + offset[sample, best]
    first_limit = in_best.kthvalue(min(3, rows), dim=-1).values
    return (int((bound <= d3[:, :, None]).sum()),
            int((bound <= first_limit[:, :, None]).sum()), bound.numel())


def compare(k, calls=None):
    """Kernel against plain version over every captured call (or the given
    (label, call) cases); returns the max abs error (indices must be
    identical) and the largest |plain| float output, which shows the
    comparison is not between zeros. Over the captured calls it also keeps
    the plain version's time in `k.plain_ms` (CUDA events around each
    call, the kernel's run before it, summed): the `plain_ms` of the
    kernel rows."""
    err = ref_max = plain_ms = 0.0
    captured = calls is None
    if captured:
        calls = [(f'main-path call {i}', c) for i, c in enumerate(k.calls)]
    for label, call in calls:
        got = k.launch(call)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        ref = k.plain(call)
        ev[1].record()
        sync()
        plain_ms += ev[0].elapsed_time(ev[1])
        ref_f = ref[0] if k.name == 'three_nn' else ref
        if ref_f.is_floating_point() and ref_f.numel():
            # (an unfilled 3-NN slot is inf on both sides)
            finite = torch.nan_to_num(ref_f.float(), posinf=0.0)
            ref_max = max(ref_max, float(finite.abs().max()))
        if k.name == 'fps':
            if not torch.equal(got, ref):
                fail(f'fps kernel indices differ from the plain version ({label})')
        elif k.name == 'three_nn':
            if not torch.equal(got[1], ref[1]):
                fail(f'three_nn kernel indices differ from the plain version ({label})')
            if not torch.allclose(got[0], ref[0], rtol=B3_DIST_TOL, atol=B3_DIST_TOL):
                fail(f'three_nn kernel distances differ from the plain version ({label})')
            diff = torch.where(got[0] == ref[0], 0.0, (got[0] - ref[0]).abs())
            err = max(err, float(diff.max()))
        elif k.name == 'rotated_iou':
            e = (float(((got - ref).abs() / ref.abs().clamp(min=1.0)).max())
                 if got.numel() else 0.0)
            if not e <= B1_ATOL:     # a NaN fails too
                fail(f'rotated_iou differs by {e} of max(1, |ref|) > {B1_ATOL} '
                     f'({label})')
            culled = b1_culled(call)
            if (got[culled] != 0).any() or (ref[culled] != 0).any():
                fail(f'rotated_iou: a culled pair is not exactly 0.0 ({label})')
            err = max(err, float((got - ref).abs().max()) if got.numel() else 0.0)
        else:
            g32, r32 = got.float(), ref.float()
            e = float(((g32 - r32).abs() / r32.abs().clamp(min=B4_FLOOR)).max())
            if not e <= B4_REL:      # a NaN fails too
                fail(f'sa_group differs by {e} of max(|ref|, {B4_FLOOR}) > {B4_REL} '
                     f'({label})')
            err = max(err, float((g32 - r32).abs().max()))
    if captured:
        k.plain_ms = plain_ms
    return err, ref_max


def library_three_nn(call):
    """torch.cdist + topk over the same inputs (a yardstick only)."""
    src, valid, q = call[1]
    d = torch.cdist(q, src) ** 2 + torch.where(valid, 0.0, 1e10)[:, None, :]
    return torch.topk(d, 3, dim=-1, largest=False)


def queued_kernels(fn):
    """Kernels and copies that one call of fn() puts on the card."""
    from torch.profiler import ProfilerActivity, profile
    fn()                                              # constants cached
    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def iou_call_kernels(rotated_iou, calls):
    """What one IoU call on the main path's largest box set queues: through
    the kernel's IoU entry point, and composed of tensor code around the
    kernel's overlap areas (corners of both sets, two area products, sum,
    difference, clamp, division), which must give the same numbers."""
    boxes = max((a[0] for _, a in calls), key=lambda t: t.shape[0])
    args = (boxes, boxes)

    def composed():
        a, b = args
        ov = rotated_iou.overlap_matrix(rotated_iou.bev_corners_ccw(a),
                                        rotated_iou.bev_corners_ccw(b))
        area_a, area_b = a[:, 3] * a[:, 4], b[:, 3] * b[:, 4]
        return ov / torch.clamp(area_a[:, None] + area_b[None, :] - ov, min=1e-6)

    diff = float((rotated_iou.iou_bev(*args) - composed()).abs().max())
    if diff != 0.0:
        fail(f'the IoU entry point differs from the composition around '
             f'overlap_matrix by {diff}: corners or epilogue round otherwise')
    return {'kernels_per_iou_call': queued_kernels(lambda: rotated_iou.iou_bev(*args)),
            'kernels_per_composed_iou_call': queued_kernels(composed)}


# ------------------------------------------------------------ corner cases

def fps_corner_cases():
    """(label, call) on the card: what a cluster-wide argmax over ordered
    keys puts at risk."""
    rng = np.random.RandomState(SEED)

    def case(label, pts, valid, k):
        return label, ('fps_cuda', (torch.from_numpy(pts.astype(np.float32)).cuda(),
                                    torch.from_numpy(valid).cuda(), k))

    cases = []
    pts = rng.rand(3, 300, 3) * 50
    valid = np.ones((3, 300), bool)
    valid[0] = False                                  # no valid point
    valid[1, 7:] = False                              # 7 valid < 64 picks
    valid[1, :3] = False
    valid[2, ::3] = False
    cases.append(case('no valid row / fewer valid than picks', pts, valid, 64))
    dup = np.repeat(rng.rand(1, 40, 3) * 10, 5, axis=1)     # each point 5 times
    cases.append(case('duplicated points', dup[:, rng.permutation(200)],
                      np.ones((1, 200), bool), 100))
    cases.append(case('all points equal', np.full((2, 100, 3), 1.5),
                      np.ones((2, 100), bool), 16))
    for n, k in ((1, 4), (255, 64), (2251, 256), (18432, 64)):
        valid = rng.rand(2, n) < 0.8
        valid[0] = True
        cases.append(case(f'N = {n}', rng.randn(2, n, 3) * 20, valid, k))
    # the train path's scans (each block keeps only its own points): the
    # 24000-point cap with a padded tail, and that instantiation's limit
    for n, tail, k in ((24000, 1500, 2048), (24576, 0, 1024)):
        valid = np.ones((2, n), bool)
        valid[:, n - tail:] = False
        cases.append(case(f'N = {n}, {tail} invalid rows at the end',
                          rng.randn(2, n, 3) * 20, valid, k))
    # Waymo's 180000-point scans (the 16-block cluster, which skips each
    # thread's invalid tail): a mask that is no prefix, a row without a
    # valid point, fewer valid points than picks; then the kernel's limit
    n = 180000
    valid = rng.rand(3, n) < 0.17
    valid[1] = False
    valid[2] = False
    valid[2, rng.choice(n, 300, replace=False)] = True
    cases.append(case(f'N = {n}: scattered valid points / no valid point / 300 valid '
                      f'< 1024 picks', rng.randn(3, n, 3) * 20, valid, 1024))
    n = 22 * 16 * 512
    cases.append(case(f'N = {n} (the limit), half valid', rng.randn(2, n, 3) * 20,
                      rng.rand(2, n) < 0.5, 1024))
    return cases


def sa_corner_cases():
    """(label, call) on the card: ball counts at and around nsample, empty
    balls, ragged P and G, one RoI, many points per RoI."""
    rng = np.random.RandomState(SEED + 1)
    h, radii, nsamples = 64, (0.8, 1.6), (16, 32)

    def case(label, centers, xyz, valid, ns=nsamples):
        r, g, p = centers.shape[0], centers.shape[1], xyz.shape[1]
        f = lambda a, dt=torch.float32: torch.from_numpy(
            np.asarray(a, np.float32)).cuda().to(dt)
        return label, ('sa_group_pool_cuda', (
            f(centers), f(xyz), torch.from_numpy(valid).cuda(),
            f(rng.randn(2, r, p, h), torch.bfloat16), f(rng.randn(2, r, g, h)),
            f(rng.randn(2, h, h) / 8, torch.bfloat16), f(rng.randn(2, h) * 0.5),
            # b2 > 0: a slot wrongly filled with zeros would pool relu(b2)
            f(0.5 + rng.rand(2, h)), radii, ns))

    def unit(n):
        v = rng.randn(n, 3)
        return v / np.linalg.norm(v, axis=1, keepdims=True)

    # RoI i: `a` points 0.4 m from the origin (in both balls), `b` points
    # 1.2 m away (in the larger ball only), the rest 100 m away; center 0 is
    # the origin, centers 1-2 a millimetre off it, centers 3-4 see nothing.
    counts = ((16, 16), (17, 0), (0, 0), (0, 5), (1, 0), (16, 17), (3, 14),
              (15, 2), (0, 32))
    p = 80
    xyz = np.full((len(counts), p, 3), 100.0)
    for i, (a, b) in enumerate(counts):
        pts = np.concatenate([unit(a) * 0.4, unit(b) * 1.2])
        slots = np.sort(rng.permutation(p)[:a + b])
        xyz[i, slots] = pts[rng.permutation(a + b)]
    centers = np.zeros((len(counts), 5, 3))
    centers[:, 1:3] = rng.randn(len(counts), 2, 3) * 1e-3
    centers[:, 3:] = -50.0
    cases = [case('ball counts 0/1/16/17/32/33', centers, xyz,
                  np.ones((len(counts), p), bool))]
    for r, g, p in ((1, 37, 1), (2, 37, 33), (3, 50, 512), (1, 1, 64), (2, 9, 8192)):
        cases.append(case(
            f'R = {r}, G = {g}, P = {p}, valid sparse', rng.randn(r, g, 3) * 0.7,
            rng.randn(r, p, 3), rng.rand(r, p) < (0.3 if p < 8192 else 0.02)))
    cases.append(case('nsamples (32, 32)', rng.randn(2, 20, 3) * 0.5,
                      rng.randn(2, 300, 3), rng.rand(2, 300) < 0.9, ns=(32, 32)))
    return cases


def three_nn_corner_cases():
    """(label, call) on the card: what skipping tiles and merging 32 lanes'
    lists put at risk. Sources (B, N, 3), valid (B, N), queries (B, M, 3)."""
    rng = np.random.RandomState(SEED + 2)

    def case(label, src, valid, q):
        f = lambda a: torch.from_numpy(np.asarray(a, np.float32)).cuda()
        return label, ('three_nn_cuda', (f(src), torch.from_numpy(valid).cuda(), f(q)))

    cases = []
    src = rng.randn(4, 700, 3) * 10
    valid = np.zeros((4, 700), bool)
    valid[1, 300] = True                              # one valid source
    valid[2, [5, 699]] = True                         # two
    valid[3] = rng.rand(700) < 0.5                    # not a prefix
    cases.append(case('0 / 1 / 2 valid sources, a valid mask with holes',
                      src, valid, rng.randn(4, 65, 3) * 10))
    cases.append(case('sources in random order', rng.rand(2, 5000, 3) * [70, 80, 4],
                      rng.rand(2, 5000) < 0.9, rng.rand(2, 777, 3) * [70, 80, 4]))
    # the same point on rows 126-130 (both sides of a tile boundary of 128
    # rows, and of 64 and 256 with the copies at 62-66 and 254-258)
    src = rng.randn(1, 600, 3) * 5
    for start in (62, 126, 254):
        src[0, start:start + 5] = src[0, start]
    cases.append(case('equal distances across a tile boundary', src,
                      np.ones((1, 600), bool),
                      np.concatenate([src[:, [62, 126, 254]], rng.randn(1, 30, 3) * 5], 1)))
    for n in (1, 2, 129):
        cases.append(case(f'N = {n}', rng.randn(2, n, 3) * 3, np.ones((2, n), bool),
                          rng.randn(2, 33, 3) * 3))
    # voxel centers in key order (y, x, z), a valid prefix; queries on cell
    # corners are equally far from up to 8 centers
    gy, gx, gz = np.meshgrid(np.arange(40), np.arange(50), np.arange(4), indexing='ij')
    grid = np.stack([gx, gy, gz], -1).reshape(1, -1, 3) * [0.4, 0.4, 0.5]
    grid = grid[:, rng.rand(grid.shape[1]) < 0.7]
    valid = np.arange(grid.shape[1])[None] < grid.shape[1] - 300
    q = np.concatenate([rng.rand(1, 500, 3) * [20, 16, 2],
                        (rng.randint(0, 30, (1, 500, 3)) + 0.5) * [0.4, 0.4, 0.5]], 1)
    cases.append(case('voxel grid in key order, queries at ties', grid, valid, q))
    cases.append(case('all sources equal', np.full((1, 300, 3), 2.5),
                      rng.rand(1, 300) < 0.7, rng.randn(1, 7, 3)))
    # more tile boxes than 48 KB of shared memory hold: the opt-in launch
    n = 460000
    cases.append(case(f'N = {n}', rng.rand(1, n, 3) * [70, 80, 4],
                      rng.rand(1, n) < 0.9, rng.rand(1, 40, 3) * [70, 80, 4]))
    return cases


def rotated_iou_corner_cases():
    """(label, call) on the card: what the cull, the upper triangle and the
    corners computed inside the kernel put at risk."""
    rng = np.random.RandomState(SEED + 3)
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32)).cuda()

    def boxes(n, extent, max_size=5.0):
        return np.concatenate([
            rng.uniform(-extent, extent, (n, 2)), rng.uniform(-1, 1, (n, 1)),
            rng.uniform(1.0, max_size, (n, 2)), rng.uniform(1.0, 2.0, (n, 1)),
            rng.uniform(-np.pi, np.pi, (n, 1))], axis=1)

    def axis_boxes(xy, size, heading=0.0):
        out = np.zeros((len(xy), 7))
        out[:, :2], out[:, 3:6], out[:, 6] = xy, size, heading
        return out

    cases = []
    far = boxes(40, 2.0)
    far[:, :2] += np.stack(np.meshgrid(np.arange(8), np.arange(5)), -1).reshape(-1, 2) * 20.0
    cases.append(('well separated boxes', ('iou_bev_cuda', (f(far), f(far[::-1].copy())))))
    lattice = np.stack(np.meshgrid(np.arange(6.0), np.arange(6.0)), -1).reshape(-1, 2)
    unit = axis_boxes(lattice, 1.0)                   # share edges and corners
    diamonds = axis_boxes(lattice * np.sqrt(2.0), 1.0, np.pi / 4)   # touch at corners
    cases.append(('boxes touching along edges and at corners',
                  ('iou_bev_cuda', (f(unit), f(np.concatenate([unit, diamonds]))))))
    cases.append(('touching boxes, upper triangle',
                  ('iou_bev_upper_cuda', (f(np.concatenate([diamonds, unit])),))))
    nested = boxes(30, 3.0)
    inner = nested.copy()
    inner[:, 3:5] *= 0.5
    cases.append(('identical and nested boxes',
                  ('iou_bev_cuda', (f(np.concatenate([nested, inner])), f(nested)))))
    zeros = boxes(70, 6.0)
    zeros[::7] = 0.0                                  # the NMS kept buffer's rows
    zeros[3::7, 3:6] = 0.0                            # a point elsewhere
    zeros[5::7, 4] = 0.0                              # a segment
    cases.append(('boxes of size 0', ('iou_bev_cuda', (f(boxes(50, 6.0)), f(zeros)))))
    cases.append(('boxes of size 0, upper triangle', ('iou_bev_upper_cuda', (f(zeros),))))
    for n, m in ((1, 1), (33, 65), (100, 31)):
        cases.append((f'N = {n}, M = {m}', ('iou_bev_cuda', (f(boxes(n, 8.0)), f(boxes(m, 8.0))))))
    for n in (1, 33, 70):
        cases.append((f'upper triangle, N = {n}', ('iou_bev_upper_cuda', (f(boxes(n, 8.0)),))))
    shifted = boxes(80, 10.0)
    shifted[:, :2] += (8000.0, -6000.0)               # coarse coordinates
    shifted[:, 6] *= 30.0                             # headings of many turns
    cases.append(('far from the origin, headings of many turns',
                  ('iou_bev_cuda', (f(shifted), f(shifted[::-1].copy())))))
    from fv2p_torch.ops.cuda.rotated_iou import bev_corners_ccw
    ca, cb = bev_corners_ccw(f(boxes(45, 6.0))), bev_corners_ccw(f(boxes(77, 6.0)))
    cases.append(('areas from corners, N = 45, M = 77',
                  ('overlap_matrix_cuda', (ca.contiguous(), cb.contiguous()))))
    # extents as MGAF decodes them (raw, no exp): negative, zero and mixed
    # sign, on the centers of ordinary boxes (near) or 60 m from every box
    normal = boxes(12, 6.0)
    extents = np.array([(-3.0, 1.5), (2.5, -1.2), (-2.0, -1.6), (0.0, 1.5), (1.8, 0.0),
                        (0.0, 0.0), (-1e-3, 2.0), (0.0, -1.0), (-4.0, -0.5)])
    for where, shift in (('near', 0.0), ('far', 60.0)):
        odd = normal[:len(extents)].copy()
        odd[:, 3:5] = extents
        odd[:, :2] += rng.uniform(-0.4, 0.4, (len(extents), 2)) + (shift, 0.0)
        label = f'negative, zero and mixed-sign extents, {where}'
        cases += [(f'{label}: as rows', ('iou_bev_cuda', (f(odd), f(normal)))),
                  (f'{label}: as columns', ('iou_bev_cuda', (f(normal), f(odd)))),
                  (f'{label}: one set, upper triangle',
                   ('iou_bev_upper_cuda', (f(np.concatenate([normal, odd])),)))]
    return cases


def corner_phase(by_name):
    """Kernel against plain on the corner cases; fails the run on a mismatch."""
    for name, cases in (('fps', fps_corner_cases()), ('sa_group', sa_corner_cases()),
                        ('three_nn', three_nn_corner_cases()),
                        ('rotated_iou', rotated_iou_corner_cases())):
        err, ref_max = compare(by_name[name], cases)
        log(f'# {name}: {len(cases)} corner cases agree with the plain version '
            f'(max abs error {err}, largest |plain output| {ref_max})')


# --------------------------------------------------------------- the run

def kernel_list():
    """The four kernels with their wrapper modules and plain versions."""
    from fv2p_torch.ops.cuda import fps, rotated_iou, sa_group, three_nn
    return [
        Kernel('rotated_iou', rotated_iou,
               {'iou_bev_cuda': 'iou_bev_plain',
                'iou_bev_upper_cuda': 'iou_bev_upper_plain',
                'overlap_matrix_cuda': 'overlap_matrix_plain'},
               'fv2p_torch/ops/csrc/rotated_iou.cu',
               'fv2p_tpu/ops/pallas/rotated_iou.py:125'),
        Kernel('fps', fps, {'fps_cuda': 'fps_plain'}, 'fv2p_torch/ops/csrc/fps.cu',
               'fv2p_tpu/ops/pallas/fps.py:89'),
        Kernel('three_nn', three_nn, {'three_nn_cuda': 'three_nn_plain'},
               'fv2p_torch/ops/csrc/three_nn.cu',
               'fv2p_tpu/ops/pallas/three_nn.py:124'),
        Kernel('sa_group', sa_group, {'sa_group_pool_cuda': 'sa_group_pool_plain'},
               'fv2p_torch/ops/csrc/sa_group.cu',
               'fv2p_tpu/ops/pallas/sa_group.py:153'),
    ]


def nvidia_smi():
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def load_cfg(path):
    from fv2p_torch.config import EasyDict, cfg_from_yaml_file
    cfg = EasyDict()
    cfg_from_yaml_file(str(path), cfg)
    return cfg


def plain_dict(d):
    """An EasyDict tree as plain dicts and lists (for yaml.safe_dump)."""
    if isinstance(d, dict):
        return {k: plain_dict(v) for k, v in d.items()}
    return [plain_dict(x) for x in d] if isinstance(d, (list, tuple)) else d


def kitti_train_caps():
    """fv2p.yaml's level capacities, for the yamls of the same trunk that set
    none (SECOND, PV-RCNN, PartA2) when they train on data/kitti: their
    derived ones drop rows under gt sampling (`kitti_second`)."""
    return plain_dict(load_cfg(CFG).MODEL.BACKBONE_3D.LEVEL_CAPACITIES)


def build_inputs():
    from fv2p_torch.datasets import dataset_meta_from_cfg
    from fv2p_torch.utils.synthetic import synthetic_batch_np
    cfg = load_cfg(CFG)
    meta = dataset_meta_from_cfg(cfg.DATA_CONFIG, 'train')
    t0 = time.perf_counter()
    batch_np = synthetic_batch_np(meta, BATCH, N_CAP, N_FILL,
                                  n_points=N_POINTS, seed=SEED)
    host_s = time.perf_counter() - t0
    return cfg, meta, batch_np, host_s


def make_model(cfg, meta, dtype, calibrate_on=None, cls_shift=0.0):
    """The model with seeded weights; with `calibrate_on` (a batch on the
    card) its BatchNorm statistics are set from one forward over it. MGAF
    needs that: with identity statistics its activations shrink layer by
    layer and no heat-map logit clears the score threshold. FV2P keeps
    identity statistics: its detections survive without them. `cls_shift`
    is added to the multihead's class-conv biases (``*_cls_out``)."""
    from fv2p_torch.models import build_network
    from fv2p_torch.weights import calibrate_batchnorm_, init_random_
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), cfg.CLASS_NAMES,
                          meta, compute_dtype=dtype)
    init_random_(model, seed=SEED)
    if calibrate_on is not None:
        calibrate_batchnorm_(model, calibrate_on)
    with torch.no_grad():
        for name, m in model.named_modules():
            if name.endswith('_cls_out'):
                m.bias.add_(cls_shift)
    return model


def forward(model, batch):
    """One inference pass over the batch already on the card (the model
    adds its outputs to a fresh copy of the batch dict)."""
    return model(dict(batch))


def check_outputs(out, post, keys, batch_size=BATCH):
    """Detections of the expected shapes (`batch_size` scans of `post`
    slots; the boxes as wide as the decoded ones: 9 columns with nuScenes'
    velocities), finite, at least one valid; the model's other outputs
    `keys` finite too."""
    box_dim = out['batch_box_preds'].shape[-1] if 'batch_box_preds' in out else 7
    b = batch_size
    for key, shape in (('pred_boxes', (b, post, box_dim)), ('pred_scores', (b, post)),
                       ('pred_labels', (b, post)), ('pred_valid', (b, post))):
        if tuple(out[key].shape) != shape:
            fail(f'{key} has shape {tuple(out[key].shape)}, expected {shape}')
    for key in ('pred_boxes', 'pred_scores') + keys:
        if not torch.isfinite(out[key].float()).all():
            fail(f'{key} is not finite')
    n_valid = int(out['pred_valid'].sum())
    if n_valid == 0:
        fail('no detection survived post-processing')
    return n_valid


@contextlib.contextmanager
def full_f32():
    """f32 convolutions and products without TF32, the defaults restored
    after."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision('highest')
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


@contextlib.contextmanager
def deterministic():
    """PyTorch's deterministic algorithms (warning where an operation has
    none) and cuDNN's deterministic convolutions, the defaults restored
    after: float atomics (index_add, cuDNN's weight gradients) then add in a
    fixed order, so two runs of one step agree to the bit."""
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved[2:]


def timed_forwards(model, batch, n):
    """Host-clock ms of n forwards, each ended by a synchronise."""
    ms = []
    for _ in range(n):
        sync()
        t0 = time.perf_counter()
        forward(model, batch)
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms


def profiled(fn):
    """One fn() (a forward, a train step) under torch.profiler: the device's
    busy share of the wall time (kernel and copy time on the card over host
    time) and the kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name[:90]] = by_name.get(e.name[:90], 0.0) + e.device_time / 1e3
    busy_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    return {'wall_ms': wall_ms, 'device_busy_ms': busy_ms,
            'busy_share': busy_ms / wall_ms, 'top_device_ms': dict(top)}


def host_syncs(fn):
    """Calls in one fn() (a forward, a train step) that make the host wait
    for the card (CUDA sync debug mode), counted by the source line that
    made them."""
    import warnings
    sites = {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        torch.cuda.set_sync_debug_mode('warn')
        try:
            fn()
            sync()
        finally:
            torch.cuda.set_sync_debug_mode('default')
    for w in caught:
        if 'synchroniz' not in str(w.message):
            continue
        path = Path(w.filename)
        where = path.relative_to(REPO) if path.is_relative_to(REPO) else path.name
        site = f'{where}:{w.lineno}'
        sites[site] = sites.get(site, 0) + 1
    return sum(sites.values()), dict(sorted(sites.items(), key=lambda kv: -kv[1]))


def module_times(model, run, tail='post_processing'):
    """ms per top-level module of one run() (CUDA events): a forward, whose
    post-processing follows the last module, or a train step, whose loss,
    backward and optimizer step follow it (`tail` names that stretch)."""
    from fv2p_torch.models.detectors.detector3d_template import MODULE_TOPOLOGY
    events = {}
    handles = []
    for slot in MODULE_TOPOLOGY:
        if not hasattr(model, slot):
            continue
        mod = getattr(model, slot)
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        events[slot] = ev
        handles.append(mod.register_forward_pre_hook(lambda m, a, e=ev: e[0].record()))
        handles.append(mod.register_forward_hook(lambda m, a, o, e=ev: e[1].record()))
    end = torch.cuda.Event(enable_timing=True)
    sync()
    run()
    end.record()
    sync()
    for h in handles:
        h.remove()
    times = {slot: e[0].elapsed_time(e[1]) for slot, e in events.items()}
    last = list(events.values())[-1]
    times[tail] = last[1].elapsed_time(end)
    return times


def forward_stats(model, batch, label, batch_size=BATCH):
    """Median and quartiles of FORWARD_REPS forwards after 2 warm-ups, the
    per-module times (median of MODULE_REPS more: one pass can catch a host
    stall that idles the card inside any module) and the peak device memory
    of one more (the resident models and batch included)."""
    timed_forwards(model, batch, 2)                      # warm-up
    fwd = np.array(timed_forwards(model, batch, FORWARD_REPS))
    q1, med, q3 = (float(x) for x in np.percentile(fwd, [25, 50, 75]))
    passes = [module_times(model, lambda: forward(model, batch)) for _ in range(MODULE_REPS)]
    per_module = {m: float(np.median([p[m] for p in passes])) for m in passes[0]}
    torch.cuda.reset_peak_memory_stats()
    forward(model, batch)
    sync()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f'# {label} bf16 forward at batch {batch_size}: median {med:.2f} ms '
        f'(quartiles {q1:.2f}-{q3:.2f}, n={FORWARD_REPS}; {med / batch_size:.2f} ms/scan); '
        f'peak device memory {peak:.2f} GiB')
    log(f'# {label} per module (ms, median of {MODULE_REPS}): {per_module}')
    return {'forward_ms': {'median': med, 'q1': q1, 'q3': q3, 'min': float(fwd.min()),
                           'max': float(fwd.max()), 'n': FORWARD_REPS,
                           'all': fwd.tolist()},
            'ms_per_scan': med / batch_size, 'per_module_ms': per_module,
            'peak_mem_gib': peak}


def profile_stats(model, batch, label):
    """The device's busy share of one profiled pass and the host waits of one
    forward by source line."""
    prof = profiled(lambda: forward(model, batch))
    n_syncs, sync_sites = host_syncs(lambda: forward(model, batch))
    log(f'# {label}: device busy {prof["busy_share"]:.1%} of a profiled pass '
        f'({prof["device_busy_ms"]:.2f} of {prof["wall_ms"]:.2f} ms)')
    log(f'# {label} host waits in one forward: {n_syncs}; by line: {sync_sites}')
    return {'profile': prof, 'host_syncs': n_syncs, 'host_sync_sites': sync_sites}


def fv2p_nms_keeps(kernels, model, head_io, out, label):
    """FV2P's proposal NMS (the RoI head's TEST config on the dense head's
    predictions, `head_io`) and its final NMS through B1 and through its
    plain version: the keep lists must be identical."""
    from fv2p_torch.models.roi_heads.iouguided_roi_head import proposal_layer
    nms_cfg = model.model_cfg.ROI_HEAD.NMS_CONFIG.TEST
    final_in = {k: out[k] for k in ('batch_box_preds', 'batch_cls_preds',
                                    'batch_iouscore_preds', 'roi_labels',
                                    'has_class_labels', 'cls_preds_normalized')}
    ker = (proposal_layer(head_io['box'], head_io['cls'], nms_cfg),
           model.post_processing_withfgscores(dict(final_in)))
    with patched(kernels, plain_route):
        pln = (proposal_layer(head_io['box'], head_io['cls'], nms_cfg),
               model.post_processing_withfgscores(dict(final_in)))
    if not (torch.equal(ker[0][0], pln[0][0]) and torch.equal(ker[0][3], pln[0][3])):
        fail(f'{label}: proposal NMS keeps differ between kernel and plain overlaps')
    for key in ('pred_boxes', 'pred_valid', 'pred_labels'):
        if not torch.equal(ker[1][key], pln[1][key]):
            fail(f'{label}: final NMS {key} differs between kernel and plain overlaps')
    log(f'# {label}: NMS keep lists identical (proposal NMS {int(ker[0][3].sum())} RoIs, '
        f'final NMS {int(ker[1]["pred_valid"].sum())} detections)')


def mgaf_main_path(kernels, model, batch):
    """MGAF's forward, counted: B1 once per scan (the final NMS of 50
    candidates), the sparse conv once per trunk conv, the DCN once per
    deformable conv, and no other kernel.
    Returns (output, B1 with its calls, launches)."""
    from fv2p_torch.ops import cuda as kcuda
    b1 = next(k for k in kernels if k.name == 'rotated_iou')
    b1 = Kernel(b1.name, b1.module, b1.entries, b1.source, b1.replaces)
    kcuda.reset_launch_counts()
    with patched([b1], capturing):
        out = forward(model, batch)
    sync()
    launches = dict(kcuda.launch_counts)
    log(f'# mgaf main path launches: {launches}')
    for name, n in launches.items():
        want = {'rotated_iou': BATCH, 'sparse_conv': SPARSE_TRUNK_CONVS,
                'dcn': MGAF_DCN_CALLS}.get(name, 0)
        if n != want:
            fail(f'mgaf: {name} launched {n} times on the main path, expected {want}')
    if len(b1.calls) != BATCH:
        fail(f'mgaf: {launches["rotated_iou"]} launches, {len(b1.calls)} calls')
    return out, b1, launches


def sparse_conv_phase(model, meta):
    """The sparse conv kernel on the 21 convs of one fv2p_kitti_infer batch
    (FV2P's trunk in eval): each call held to the plain version (SC_REL of
    the larger output plus SC_SUM_REL of the sum of |terms|), then the
    kernel, the plain version and ``_SparseConvFn``'s forward, PyTorch's
    gather + torch.matmul (``library_ms``), timed with CUDA
    events beside the bound: the features, weights, tables and f32 output
    moved once, the products of the (row, tap) pairs that name a real row.
    Returns (record, the captured calls for the profiler)."""
    from fv2p_torch.ops.cuda import sparse_conv as sc
    from fv2p_torch.ops.sparse import conv
    from fv2p_torch.utils.synthetic import batch_to_torch, synthetic_batch_np
    batch = batch_to_torch(synthetic_batch_np(meta, BATCH, SC_N_CAP, N_FILL, 512, seed=SEED),
                           'cuda')
    calls, real = [], conv.sparse_conv_fwd
    conv.sparse_conv_fwd = lambda *a: calls.append(a) or real(*a)
    try:
        with torch.no_grad():
            model.backbone_3d(model.vfe(dict(batch)))
    finally:
        conv.sparse_conv_fwd = real
    sync()
    if len(calls) != SPARSE_TRUNK_CONVS:
        fail(f'sparse_conv: {len(calls)} calls in the trunk, expected {SPARSE_TRUNK_CONVS}')

    per_call, worst, equal = [], 0.0, 0
    bytes_, ops, ops_cap = 0, 0, 0
    for f, w, nbr, bias, valid in calls:
        got, ref = sc.sparse_conv_fwd_cuda(f, w, nbr), sc.sparse_conv_fwd_plain(f, w, nbr)
        s = sc.sparse_conv_fwd_plain(f.abs().float(), w.abs().float(), nbr)
        excess = float(((got - ref).abs() - SC_REL * torch.maximum(got.abs(), ref.abs())
                        - SC_SUM_REL * s).max())
        if excess > 0:
            fail(f'sparse_conv {tuple(w.shape)}: kernel and plain differ past the tolerance '
                 f'by {excess}')
        worst = max(worst, float((got - ref).abs().max()))
        equal += int(torch.equal(got, ref))
        k, cin, cout = w.shape
        pairs = int((nbr != f.shape[0]).sum())
        b = (f.numel() * 2 + w.numel() * 2 + nbr.numel() * 8 + nbr.shape[0] * (cout * 4 + 1)
             + cout * 4)
        bytes_, ops, ops_cap = bytes_ + b, ops + 2 * pairs * cin * cout, \
            ops_cap + 2 * nbr.numel() * cin * cout
        per_call.append({'shape': [k, cin, cout], 'n_in': f.shape[0], 'n_out': nbr.shape[0],
                         'pair_share': pairs / nbr.numel(),
                         'ms': time_events(lambda: sc.sparse_conv_fwd_cuda(f, w, nbr, bias, valid),
                                           reps=10)})
    rec = {'launches': SPARSE_TRUNK_CONVS, 'max_abs_err': worst, 'bitwise_equal_calls': equal,
           'per_call': per_call,
           'ms': time_events(lambda: [sc.sparse_conv_fwd_cuda(*a) for a in calls], reps=10),
           'plain_ms': time_events(lambda: [sc.sparse_conv_fwd_plain(*a) for a in calls], reps=3),
           'library_ms': time_events(lambda: [conv._conv_fwd(*a[:3]) for a in calls], reps=3),
           'bytes': bytes_, 'ops': ops, 'ops_at_capacity': ops_cap,
           'bound_ms': max(bytes_ / HBM_BYTES_S, ops / BF16_OPS_S) * 1e3,
           'bound_by': 'bytes' if bytes_ / HBM_BYTES_S >= ops / BF16_OPS_S else 'operations'}
    log(f'# sparse_conv: {rec["ms"]:.3f} ms kernel for the trunk\'s {len(calls)} convs, '
        f'{rec["plain_ms"]:.3f} ms plain, {rec["library_ms"]:.3f} ms gather + torch.matmul, '
        f'bound {rec["bound_ms"]:.4f} ms ({rec["bound_by"]}: {bytes_ / 1e9:.3f} GB, '
        f'{ops / 1e9:.1f} GFLOP of {ops_cap / 1e9:.1f} at capacity); largest |kernel - plain| '
        f'{worst}, {equal} of {len(calls)} calls equal to the bit')
    return rec, calls


def mgaf_nms_keeps(kernels, model, out):
    """The final NMS on MGAF's decoded candidates through the kernel and
    through the plain version: the keep lists must be identical."""
    final_in = {k: out[k] for k in ('batch_box_preds', 'batch_cls_preds',
                                    'batch_iouscore_preds', 'cls_preds_normalized')}
    ker = model.post_processing_withfgscores(dict(final_in))
    with patched(kernels, plain_route):
        pln = model.post_processing_withfgscores(dict(final_in))
    for key in ('pred_boxes', 'pred_valid', 'pred_labels'):
        if not torch.equal(ker[key], pln[key]):
            fail(f'mgaf final NMS {key} differs between kernel and plain overlaps')
    log('# mgaf: final NMS keep lists identical')


def f32_forward(kernels, cfg, meta, batch, post, keys, label, compare_keys,
                calibrate=False, cls_shift=0.0, batch_size=BATCH):
    """The forward in f32 without TF32 through the kernels and through the
    plain versions: identical detections, floats within F32_ATOL."""
    with full_f32():
        model32 = make_model(cfg, meta, None, batch if calibrate else None, cls_shift)
        out_k = forward(model32, batch)
        with patched(kernels, plain_route):
            out_p = forward(model32, batch)
        sync()
    check_outputs(out_k, post, keys, batch_size)
    for key in ('pred_valid', 'pred_labels'):
        if not torch.equal(out_k[key], out_p[key]):
            fail(f'{label} f32 forward: {key} differs between kernels and plain versions')
    diffs = {}
    for key in compare_keys:
        diffs[key] = float((out_k[key] - out_p[key]).abs().max())
        if diffs[key] > F32_ATOL:
            fail(f'{label} f32 forward: {key} differs by {diffs[key]} > {F32_ATOL}')
    log(f'# {label} f32 forward, kernels vs plain versions: {diffs}; '
        f'{int(out_k["pred_valid"].sum())} valid detections')
    del model32, out_k, out_p
    torch.cuda.empty_cache()
    return diffs


def dcn_times(model, batch):
    """Every modulated_deform_conv call of one MGAF forward, replayed on the
    same card tensors (CUDA events), beside the least time the card could
    take: bytes in and out over the memory rate, MACs x 2 over the peak.
    An eval forward sends each call to the sample-and-MMA kernel
    (ops/csrc/dcn.cu): its launches are counted (one a call), and the
    kernel alone (on the operands as the wrapper makes them contiguous) and
    the plain version (the tensor code's arithmetic) are timed on the same
    calls, each kernel call held to the plain version within the tolerance
    of tests/test_torch_dcn_kernel.py."""
    from fv2p_torch.ops import cuda as kcuda
    from fv2p_torch.ops import dcn
    from fv2p_torch.ops.cuda import dcn as cdcn
    calls, orig = [], dcn.modulated_deform_conv

    def capture(*args):
        calls.append(args)
        return orig(*args)

    kcuda.reset_launch_counts()
    dcn.modulated_deform_conv = capture
    try:
        forward(model, batch)
    finally:
        dcn.modulated_deform_conv = orig
    sync()
    launches = kcuda.launch_counts['dcn']
    if launches != len(calls) or len(calls) != MGAF_DCN_CALLS:
        fail(f'mgaf DCN: {launches} kernel launches for {len(calls)} calls in an eval '
             f'forward, expected {MGAF_DCN_CALLS}')
    per_call = [time_events(lambda a=a: orig(*a), reps=5) for a in calls]
    total = time_events(lambda: [orig(*a) for a in calls], reps=5)
    ops = [(tuple(t.contiguous() for t in a[:5]), a[6]) for a in calls]
    kernel_ms = time_events(lambda: [cdcn.mdcn_fwd_cuda(*o, g) for o, g in ops], reps=5)
    kernel_device_ms = device_ms(lambda: [cdcn.mdcn_fwd_cuda(*o, g) for o, g in ops])
    plain_ms = time_events(lambda: [cdcn.mdcn_fwd_plain(*o, g) for o, g in ops], reps=3)
    errs, equal = [], 0
    for (x, dy, dx, mask, w), g in ops:
        got = cdcn.mdcn_fwd_cuda(x, dy, dx, mask, w, g)
        ref = cdcn.mdcn_fwd_plain(x, dy, dx, mask, w, g)
        s = cdcn.mdcn_fwd_plain(x.abs(), dy, dx, mask, w.abs(), g)
        tol = (2.0 ** -23 * w.shape[0] * w.shape[1] * s
               + 2.0 ** -8 * float(x.abs().max()) * float(w.abs().max()))
        err = (got - ref).abs()
        if bool((err > tol).any()):
            fail(f'mgaf DCN {tuple(w.shape)}: kernel and plain differ past the tolerance '
                 f'(max {float(err.max())})')
        errs.append(float(err.max()))
        equal += bool(torch.equal(got, ref))
    peak_gib = []                    # device memory a call takes beyond its inputs
    for a in calls:
        sync()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        orig(*a)
        sync()
        peak_gib.append((torch.cuda.max_memory_allocated() - base) / 2 ** 30)
    bounds = [bound_dcn(a) for a in calls]
    b_bytes, b_ops, macs = (sum(x) for x in zip(*bounds))
    rec = {'calls': len(calls), 'ms': total, 'per_call_ms': per_call,
           'launches': launches, 'kernel_ms': kernel_ms, 'kernel_device_ms': kernel_device_ms,
           'plain_ms': plain_ms,
           'max_abs_err': errs, 'bit_equal_calls': equal,
           'per_call_peak_gib': peak_gib,
           'shapes': [[list(a[0].shape), list(a[4].shape), a[6]] for a in calls],
           'macs': macs, 'bound_ms': max(b_bytes, b_ops) * 1e3,
           'bound_bytes_ms': b_bytes * 1e3, 'bound_ops_ms': b_ops * 1e3,
           'bound_by': 'bytes' if b_bytes >= b_ops else 'operations'}
    log(f'# mgaf DCN: {len(calls)} calls, {total:.3f} ms a forward (per call '
        f'{[round(x, 3) for x in per_call]}); bound {rec["bound_ms"]:.4f} ms '
        f'({rec["bound_by"]}; bytes {rec["bound_bytes_ms"]:.4f}, MACs x 2 '
        f'{rec["bound_ops_ms"]:.4f}); {macs / 1e9:.1f} GMAC; device memory '
        f'beyond the inputs, per call (GiB): {[round(x, 3) for x in peak_gib]}')
    log(f'# mgaf DCN kernel: {launches} launches a forward, {kernel_ms:.3f} ms for the '
        f'calls alone ({kernel_device_ms:.3f} ms device), plain version {plain_ms:.3f} ms; '
        f'{equal} of {len(ops)} calls equal to the plain version to the bit, max abs error '
        f'{errs}')
    return rec


# ----------------------------------------------------------------- training

def train_inputs(cfg, meta, batch_size, n_points):
    """A train batch of `cfg`: `batch_size` scans, the 16000-voxel train cap
    with 14000 filled, the rulebooks at the yaml's train level capacities
    (MODEL.BACKBONE_3D.LEVEL_CAPACITIES, as tools/train.py passes them), each
    scan's points padded to `n_points` as the dataset pads them, and each
    scan's six simulated cars as gt."""
    from fv2p_torch.ops.sparse.host_rulebook import select_mode_caps
    from fv2p_torch.utils.synthetic import batch_to_torch, synthetic_batch_np
    caps = select_mode_caps(cfg.MODEL.BACKBONE_3D.get('LEVEL_CAPACITIES'), training=True)
    t0 = time.perf_counter()
    batch_np = synthetic_batch_np(meta, batch_size, N_CAP, N_FILL, n_points,
                                  seed=SEED, gt='scan', pad_points=True,
                                  caps_override=caps)
    host_s = time.perf_counter() - t0
    level_caps = {k[len('coords_'):]: int(v.shape[1])
                  for k, v in batch_np['rulebooks'].items() if k.startswith('coords_')}
    return batch_to_torch(batch_np, 'cuda'), host_s, level_caps


def make_train_step(cfg, meta, dtype):
    from fv2p_torch.train_utils.train_state import TrainStep
    return TrainStep(make_model(cfg, meta, dtype), cfg.OPTIMIZATION, TRAIN_TOTAL_STEPS)


def counted_train_step(kcuda, step, batch, launched, events=None, keep_out=False):
    """One train step with the launch counts set to 0 just before it and
    read just after: each kernel in `launched` must have launched, every
    other kernel not. With `events` (four CUDA events) around forward+loss,
    backward and the optimizer step. Returns (loss terms on the card,
    launches, the forward's batch dict if keep_out)."""
    kcuda.reset_launch_counts()
    if events:
        events[0].record()
    loss, terms, out = step.forward_loss(batch)
    if events:
        events[1].record()
    step.backward(loss)
    if events:
        events[2].record()
    terms = {k: v.detach() for k, v in terms.items()}
    terms['grad_norm'] = step.update()
    if events:
        events[3].record()
    launches = dict(kcuda.launch_counts)
    for name, n in launches.items():
        if name in launched and n == 0:
            fail(f'train step {step.step_count - 1}: kernel {name} was not launched')
        if name not in launched and n != 0:
            fail(f'train step {step.step_count - 1}: kernel {name} launched {n} '
                 f'times; this train path does not run it')
    return terms, launches, (out if keep_out else None)


def train_targets(out):
    """Foreground counts of one FV2P train forward: positive anchors,
    foreground keypoints, foreground (regressed) RoIs, and the sampled RoIs."""
    return {'positive_anchors': int((out['anchor_head_ret']['box_cls_labels'] > 0).sum()),
            'foreground_keypoints': int((out['point_head_ret']['point_cls_labels'] > 0).sum()),
            'foreground_rois': int(out['roi_head_ret']['reg_valid_mask'].sum()),
            'sampled_rois': int(out['roi_head_ret']['reg_valid_mask'].numel())}


def mgaf_train_targets(out):
    """Counts of one MGAF train forward's targets: the objects that have a
    center cell (mask_target positives), the segmentation map's foreground
    cells and the heat map's peaks (cells exactly 1.0)."""
    hr = out['head_ret']
    return {'mask_target_positives': int(hr['mask_target'].sum()),
            'segm_foreground_cells': int((hr['segm_target'] > 0).sum()),
            'heatmap_peaks': int((hr['hm_target'] == 1.0).sum())}


def timed_train_steps(kcuda, step, batch, launched, targets):
    """TRAIN_WARMUP + TRAIN_TIMED bf16 steps, each counted; CUDA events
    around each phase of the timed ones; `targets(out)` of the first step's
    forward. Every loss term of every step must be finite."""
    terms_all, launches_all, rows = [], [], []
    first = None
    torch.cuda.reset_peak_memory_stats()
    for i in range(TRAIN_WARMUP + TRAIN_TIMED):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        terms, launches, out = counted_train_step(kcuda, step, batch, launched, ev,
                                                  keep_out=i == 0)
        if i == 0:
            first = targets(out)
            del out
        terms_all.append(terms)
        launches_all.append(launches)
        rows.append(ev)
    sync()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    names = sorted(terms_all[0])
    table = torch.stack([torch.stack([t[k].float() for k in names]) for t in terms_all]).cpu()
    if not torch.isfinite(table).all():
        bad = [(i, names[j]) for i, j in (~torch.isfinite(table)).nonzero().tolist()]
        fail(f'train: non-finite loss terms (step, term): {bad}')
    ms = {'forward_loss': [], 'backward': [], 'optimizer': [], 'step': []}
    for ev in rows[TRAIN_WARMUP:]:
        ms['forward_loss'].append(ev[0].elapsed_time(ev[1]))
        ms['backward'].append(ev[1].elapsed_time(ev[2]))
        ms['optimizer'].append(ev[2].elapsed_time(ev[3]))
        ms['step'].append(ev[0].elapsed_time(ev[3]))
    stats = {}
    for key, vals in ms.items():
        q1, med, q3 = (float(x) for x in np.percentile(vals, [25, 50, 75]))
        stats[key] = {'median': med, 'q1': q1, 'q3': q3, 'all': vals}
    return {'ms': stats, 'n_timed': TRAIN_TIMED,
            'loss_terms': {k: table[:, j].tolist() for j, k in enumerate(names)},
            'launches_per_step': launches_all, 'first_step_targets': first,
            'peak_mem_gib': peak}


def captured_train_calls(kernels, step, batch, launched):
    """One more counted step with every kernel call recorded (the calls the
    train path makes, for the comparison with the plain versions)."""
    from fv2p_torch.ops import cuda as kcuda
    train_k = copy_kernels(kernels)
    with patched(train_k, capturing):
        _, launches, _ = counted_train_step(kcuda, step, batch, launched)
    sync()
    for k in train_k:
        if launches[k.name] != len(k.calls):
            fail(f'train {k.name}: {launches[k.name]} launches, {len(k.calls)} calls')
    return {k.name: k for k in train_k}, launches


def compare_train_steps(label, tk, tp, gk, gp):
    """Loss terms (tk, tp) and gradients (gk, gp) of one step through the
    kernels and through the plain versions: terms within 1e-5 relative,
    every gradient within 1e-4 max|g| + 1e-7, and a bias a train-mode
    BatchNorm normalises away (true gradient 0) noise under 1e-5 of the same
    conv's kernel gradient on both sides. Returns the record."""
    rel = {k: abs(tk[k] - tp[k]) / max(abs(tp[k]), 1e-30) for k in tp}
    for k, r in rel.items():
        if r > 1e-5:
            fail(f'{label}: loss term {k} differs by {r} relative > 1e-5')
    if sorted(gk) != sorted(gp):
        fail(f'{label}: kernel and plain routes give gradients to other parameters')
    worst, zero_biases = 0.0, 0
    for name, g in gp.items():
        ref_max = float(g.abs().max())
        err = float((gk[name] - g).abs().max())
        if zero_by_construction(name):
            scale = float(gp[name[:-len('bias')] + 'kernel'].abs().max())
            if max(ref_max, float(gk[name].abs().max())) > 1e-5 * scale:
                fail(f'{label}: {name} should be noise, is {ref_max}')
            zero_biases += 1
            continue
        if err > 1e-4 * ref_max + 1e-7:
            fail(f'{label}: gradient {name} differs by {err} > 1e-4 * {ref_max} + 1e-7')
        worst = max(worst, err / (ref_max + 1e-30))
    return {'loss_rel_diff': rel, 'grad_worst_rel_to_max': worst,
            'grad_tensors': len(gp), 'zero_by_construction_biases': zero_biases,
            'loss_terms_kernel': tk}


def _grads(model):
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()
            if p.grad is not None}


def train_f32_compare(kernels, cfg, meta, batch, label='train'):
    """The first train step in f32 without TF32, from the same weights and
    generators, through the kernels and through the plain versions: FPS
    picks and proposal-NMS keeps identical, loss terms within 1e-5
    relative, every gradient within 1e-4 max|g| + 1e-7. A bias that a
    train-mode BatchNorm normalises (the sparse residual blocks' conv
    biases) has a true gradient of 0: there both sides must be noise under
    1e-5 of the same conv's kernel gradient. Gradients are not bit-identical:
    autograd's scatter-adds on the card are unordered."""
    from fv2p_torch.models.roi_heads import iouguided_roi_head as roi_mod
    from fv2p_torch.ops import pointops

    def run(route):
        picks, props = [], []
        fps_fn, prop_fn = pointops.fps, roi_mod.proposal_layer

        def fps_rec(*a):
            picks.append(fps_fn(*a))
            return picks[-1]

        def prop_rec(*a):
            props.append(prop_fn(*a))
            return props[-1]

        pointops.fps, roi_mod.proposal_layer = fps_rec, prop_rec
        try:
            with contextlib.ExitStack() as stack:
                if route == 'plain':
                    stack.enter_context(patched(kernels, plain_route))
                loss, terms, out = step.forward_loss(batch)
                step.backward(loss)
            sync()
        finally:
            pointops.fps, roi_mod.proposal_layer = fps_fn, prop_fn
        terms = {k: float(v.detach()) for k, v in terms.items()}
        return terms, _grads(step.model), picks, props, out['roi_head_ret']['rois'].detach()

    with full_f32():
        step = make_train_step(cfg, meta, None)
        tk, gk, pk, nk, rk = run('kernel')
        tp, gp, pp, np_, rp = run('plain')
    if len(pk) != 1 or not torch.equal(pk[0], pp[0]):
        fail(f'{label} f32 step: FPS picks differ between kernel and plain')
    for a, b in zip(nk[0], np_[0]):
        if not torch.equal(a, b):
            fail(f'{label} f32 step: proposal NMS keeps differ between kernel and plain')
    if not torch.equal(rk, rp):
        fail(f'{label} f32 step: sampled RoIs differ between kernel and plain')
    rec = compare_train_steps(f'{label} f32 step', tk, tp, gk, gp)
    log(f'# {label} f32 step, kernels vs plain versions: FPS picks and proposal keeps '
        f'identical; loss terms max relative difference {max(rec["loss_rel_diff"].values()):.3g}; '
        f'{len(gp)} gradient tensors, worst error {rec["grad_worst_rel_to_max"]:.3g} of the '
        f'tensor\'s max ({rec["zero_by_construction_biases"]} biases normalised away held '
        f'to noise)')
    del step
    torch.cuda.empty_cache()
    return rec


def zero_by_construction(name):
    """The conv biases of the sparse residual blocks (FV2P's trunk, UNetV2's
    decoder): a train-mode BatchNorm follows each, so their true gradient
    is 0."""
    block = name.startswith('backbone_3d.res') or (
        name.startswith('backbone_3d.up') and '_t.' in name)
    return block and '.conv' in name and name.endswith('.bias')


def train_kernel_rows(train_calls, launches, rows, prefix='train', library=library_three_nn):
    """A path's calls of each kernel against the plain versions, and their
    times, added to each kernel's row of the `kernels` line under `prefix`_*
    keys (a kernel the path does not launch gets its count, 0)."""
    from fv2p_torch.ops.cuda import fps
    bounds = {'rotated_iou': bound_rotated_iou, 'fps': bound_fps,
              'three_nn': bound_three_nn, 'sa_group': bound_sa_group}
    for row in rows:
        k = train_calls[row['name']]
        row[f'{prefix}_launches'] = launches[k.name]
        if not k.calls:
            continue
        err, ref_max = compare(k)
        b_bytes, b_ops = (sum(x) for x in zip(*(bounds[k.name](a) for a in k.calls)))
        row.update({
            f'{prefix}_max_abs_err': err, f'{prefix}_ref_max': ref_max,
            f'{prefix}_ms': time_events(lambda: [k.launch(a) for a in k.calls],
                                        reps=3 if k.name == 'fps' else 10),
            f'{prefix}_plain_ms': k.plain_ms,
            f'{prefix}_bound_ms': max(b_bytes, b_ops) * 1e3,
            f'{prefix}_bound_by': 'bytes' if b_bytes >= b_ops else 'operations'})
        if k.name == 'fps':
            row[f'{prefix}_chain_floor_ms'] = time_events(
                lambda: [fps.fps_chain_floor_cuda(*a) for _, a in k.calls], reps=3)
            row[f'{prefix}_shapes'] = [list(a[0].shape) + [a[2]] for _, a in k.calls]
        if k.name == 'three_nn':
            row[f'{prefix}_library_ms'] = time_events(
                lambda: [library(a) for a in k.calls], reps=3)
        log(f'# {prefix} {k.name}: {launches[k.name]} launches, {len(k.calls)} calls '
            f'replayed, agree with the plain version (max abs error {err}); '
            f'{row[f"{prefix}_ms"]:.3f} ms kernel, '
            f'{row[f"{prefix}_plain_ms"]:.3f} ms plain, bound {row[f"{prefix}_bound_ms"]:.4f} ms '
            f'({row[f"{prefix}_bound_by"]})'
            + (f', chain floor {row[f"{prefix}_chain_floor_ms"]:.3f} ms'
               if k.name == 'fps' else '')
            + (f', library {row[f"{prefix}_library_ms"]:.3f} ms (cdist + topk)'
               if k.name == 'three_nn' else ''))


# ------------------------------------------------------------ MGAF training

def mgaf_train_f32_compare(kernels, cfg, meta, batch):
    """MGAF's first train step in f32 without TF32, from the same weights,
    through the kernels and through the plain versions: the iou-score
    targets (B1's only use on this path) identical, loss terms within 1e-5
    relative, every gradient within 1e-4 max|g| + 1e-7 (the sparse residual
    blocks' conv biases held to noise, as for FV2P)."""
    from fv2p_torch.models.dense_heads import center_af_head as head_mod

    def run(route):
        targets, orig = [], head_mod.iouscore_targets

        def rec(ret):
            targets.append(orig(ret))
            return targets[-1]

        head_mod.iouscore_targets = rec
        try:
            with contextlib.ExitStack() as stack:
                if route == 'plain':
                    stack.enter_context(patched(kernels, plain_route))
                loss, terms, _ = step.forward_loss(batch)
                step.backward(loss)
            sync()
        finally:
            head_mod.iouscore_targets = orig
        return {k: float(v.detach()) for k, v in terms.items()}, _grads(step.model), targets

    with full_f32():
        step = make_train_step(cfg, meta, None)
        tk, gk, ik = run('kernel')
        tp, gp, ip = run('plain')
    if len(ik) != 1 or len(ip) != 1 or not torch.equal(ik[0], ip[0]):
        fail('mgaf train f32 step: iou-score targets differ between kernel and plain')
    rec = compare_train_steps('mgaf train f32 step', tk, tp, gk, gp)
    iou = ik[0]
    rec['iouscore_targets'] = {'n': iou.numel(), 'above_0': int((iou > 0).sum()),
                               'above_0.25': int((iou > 0.25).sum()),
                               'max': float(iou.max())}
    log(f'# mgaf train f32 step, kernels vs plain versions: iou-score targets identical '
        f'({rec["iouscore_targets"]}); loss terms max relative difference '
        f'{max(rec["loss_rel_diff"].values()):.3g}; {len(gp)} gradient tensors, worst '
        f'error {rec["grad_worst_rel_to_max"]:.3g} of the tensor\'s max '
        f'({rec["zero_by_construction_biases"]} biases normalised away held to noise)')
    del step
    torch.cuda.empty_cache()
    return rec


def bound_dcn_backward(args):
    """The backward of one modulated_deform_conv call: its inputs and the
    f32 output gradient read once, a gradient of each input written once;
    two products a tap (the samples' gradient and the weights'), 2x the
    forward's MACs."""
    x, dy, dx, mask, w, ks, _ = args
    b, h, wd, _ = x.shape
    nbytes = 2 * sum(t.numel() * t.element_size() for t in (x, dy, dx, mask, w))
    nbytes += b * h * wd * w.shape[-1] * 4
    _, ops_s, macs = bound_dcn(args)
    return nbytes / HBM_BYTES_S, 2 * ops_s, 2 * macs


def dcn_train_times(step, batch):
    """The modulated_deform_conv calls of one MGAF train step, each replayed
    on its own inputs (CUDA events): forward alone, then forward + backward
    with an f32 output gradient; the device memory forward + backward takes
    beyond the inputs; the bounds of the forward and of the backward; and,
    after every timing, forward + backward once more under the profiler:
    the card's busy time and the kernels that take the most of it."""
    from fv2p_torch.ops import dcn
    calls, orig = [], dcn.modulated_deform_conv

    def capture(*args):
        calls.append(tuple(a.detach().clone() if torch.is_tensor(a) else a for a in args))
        return orig(*args)

    dcn.modulated_deform_conv = capture
    try:
        with torch.no_grad():
            step.forward_loss(batch)
    finally:
        dcn.modulated_deform_conv = orig
    sync()
    def fwd_bwd_of(a):
        x, dy, dx, mask, w, ks, g = a
        leaves = [t.detach().requires_grad_() for t in (x, dy, dx, mask, w)]
        dout = torch.randn(tuple(x.shape[:3]) + (w.shape[-1],), device=x.device)

        def fwd_bwd():
            for t in leaves:
                t.grad = None
            orig(*leaves, ks, g).backward(dout)
        return fwd_bwd, leaves

    per_call = []
    for a in calls:
        x, _, _, _, w, _, g = a
        with torch.no_grad():   # the train step's forward: the autograd path's, not the kernel
            fwd = time_events(lambda: dcn._ModulatedDeformConvFn.apply(*a), reps=5)
        fwd_bwd, leaves = fwd_bwd_of(a)
        both = time_events(fwd_bwd, reps=3)
        for t in leaves:
            t.grad = None
        sync()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fwd_bwd()
        sync()
        extra = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        del fwd_bwd, leaves
        f_bytes, f_ops, macs = bound_dcn(a)
        b_bytes, b_ops, _ = bound_dcn_backward(a)
        per_call.append({
            'shape': [list(x.shape), list(w.shape), g], 'forward_ms': fwd,
            'forward_backward_ms': both, 'backward_ms': both - fwd,
            'extra_gib': extra, 'macs': macs,
            'forward_bound_ms': max(f_bytes, f_ops) * 1e3,
            'backward_bound_ms': max(b_bytes, b_ops) * 1e3,
            'backward_bound_by': 'bytes' if b_bytes >= b_ops else 'operations'})
    for a, c in zip(calls, per_call):
        prof = profiled(fwd_bwd_of(a)[0])
        c.update(profiled_wall_ms=prof['wall_ms'], device_busy_ms=prof['device_busy_ms'],
                 top_device_ms=prof['top_device_ms'])
    tot = {k: sum(c[k] for c in per_call) for k in
           ('forward_ms', 'forward_backward_ms', 'backward_ms',
            'forward_bound_ms', 'backward_bound_ms')}
    log(f'# mgaf train DCN: {len(calls)} calls; forward {tot["forward_ms"]:.3f} ms, '
        f'forward + backward {tot["forward_backward_ms"]:.3f} ms (backward '
        f'{tot["backward_ms"]:.3f}); bounds forward {tot["forward_bound_ms"]:.4f}, '
        f'backward {tot["backward_bound_ms"]:.4f} ms; per call (forward, backward ms, '
        f'GiB beyond the inputs): '
        f'{[(round(c["forward_ms"], 3), round(c["backward_ms"], 3), round(c["extra_gib"], 3)) for c in per_call]}')
    for c in per_call:
        top = {k: round(v, 3) for k, v in list(c['top_device_ms'].items())[:6]}
        log(f'# mgaf train DCN {c["shape"]}: forward + backward busies the card '
            f'{c["device_busy_ms"]:.3f} ms of a profiled {c["profiled_wall_ms"]:.3f} ms; '
            f'by kernel: {top}')
    return {'calls': per_call, **tot}


def mgaf_train_phase(kernels, cfg, meta, rows):
    """MGAF-3DSSD in train mode at its batch 4, bf16 compute and f32
    parameters, on a train batch of the same kind as FV2P's (no raw points:
    MGAF reads none): the f32 step against the plain versions, the timed
    steps (each counted: B1 launches, no other kernel does), one more step
    whose B1 calls are held against the plain version and timed (the
    `mgaf_train_*` keys of `rows`), and the step's deformable convolutions,
    forward and backward. Returns the record."""
    from fv2p_torch.ops import cuda as kcuda
    batch_size = int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)
    batch, host_s, caps = train_inputs(cfg, meta, batch_size, 0)
    rec = {'batch': batch_size, 'batch_host_s': host_s, 'level_caps': caps,
             'gt_boxes': int((batch['gt_boxes'][..., 7] > 0).sum()),
             'total_steps': TRAIN_TOTAL_STEPS}
    rec['f32_kernel_vs_plain'] = mgaf_train_f32_compare(kernels, cfg, meta, batch)
    step = make_train_step(cfg, meta, torch.bfloat16)
    rec['parameters'] = sum(p.numel() for p in step.model.parameters())
    rec.update(timed_train_steps(kcuda, step, batch, ('rotated_iou',),
                                   mgaf_train_targets))
    first = rec['first_step_targets']
    if first['mask_target_positives'] <= 0 or first['segm_foreground_cells'] <= 0:
        fail(f'mgaf train: the first step has no targets: {first}')
    tms = rec['ms']
    log(f'# mgaf train bf16 step at batch {batch_size} ({rec["parameters"]} parameters, '
        f'level capacities {caps}), ms median (quartiles) of {TRAIN_TIMED}: ' + ', '.join(
            f'{k} {v["median"]:.2f} ({v["q1"]:.2f}-{v["q3"]:.2f})' for k, v in tms.items())
        + f'; peak device memory {rec["peak_mem_gib"]:.2f} GiB')
    passes = [module_times(step.model, lambda: step.step(batch),
                           tail='loss_backward_optimizer') for _ in range(MODULE_REPS)]
    rec['per_module_ms'] = {m: float(np.median([p[m] for p in passes]))
                              for m in passes[0]}
    log(f'# mgaf train step per module (ms, median of {MODULE_REPS}): '
        f'{rec["per_module_ms"]}')
    log(f'# mgaf train loss terms per step: {rec["loss_terms"]}')
    log(f'# mgaf train launches per step: {rec["launches_per_step"]}')
    log(f'# mgaf train first step targets: {first}')
    calls, rec['launches'] = captured_train_calls(kernels, step, batch,
                                                           ('rotated_iou',))
    train_kernel_rows(calls, rec['launches'], rows, prefix='mgaf_train')
    del calls
    rec['dcn'] = dcn_train_times(step, batch)
    # a train step keeps the autograd path: timed_train_steps failed any step
    # that launched the DCN kernel (it launches only B1)
    rec['dcn']['kernel_launches_per_step'] = [n['dcn'] for n in rec['launches_per_step']]
    # under the profiler and the sync debug mode, after every timed pass
    rec['host_syncs'], rec['host_sync_sites'] = host_syncs(lambda: step.step(batch))
    rec['profile'] = profiled(lambda: step.step(batch))
    top = {k: round(v, 2) for k, v in list(rec['profile']['top_device_ms'].items())[:8]}
    log(f'# mgaf train step: device busy {rec["profile"]["busy_share"]:.1%} of a profiled '
        f'step ({rec["profile"]["device_busy_ms"]:.2f} of {rec["profile"]["wall_ms"]:.2f} ms); '
        f'host waits {rec["host_syncs"]}, by line {rec["host_sync_sites"]}; by kernel: {top}')
    del step, batch
    torch.cuda.empty_cache()
    return rec


# ------------------------------------------------------- KITTI runner phases

def quiet_logger():
    """The runners' logger for this script: warnings only (the numbers the
    runners log are printed here from their records)."""
    import logging
    logger = logging.getLogger('chip_smoke.runner')
    logger.setLevel(logging.WARNING)
    return logger


def check_kitti_fixture():
    need = [KITTI / 'kitti_infos_train.pkl', KITTI / 'kitti_infos_val.pkl',
            KITTI / 'kitti_dbinfos_train.pkl', KITTI / 'gt_database',
            KITTI / 'training' / 'velodyne']
    missing = [str(p.relative_to(REPO)) for p in need if not p.exists()]
    if missing:
        fail(f'the KITTI fixture is missing {missing}: data/kitti must go with the copy')


def state_of(trainer):
    """A copy of a trainer's parameters, buffers and optimizer state."""
    opt = trainer.optimizer.state_dict()
    return ({k: v.detach().clone() for k, v in trainer.model.state_dict().items()},
            opt['count'], [m.clone() for m in opt['mu']], [n.clone() for n in opt['nu']])


def saved_state(path):
    ckpt = torch.load(path, map_location='cuda', weights_only=True)
    opt = ckpt['optimizer_state']
    return ckpt['model_state'], opt['count'], list(opt['mu']), list(opt['nu'])


def states_equal(a, b):
    """Bit for bit: every tensor of the model's state, the one-cycle step and
    both Adam moments."""
    return (sorted(a[0]) == sorted(b[0])
            and all(torch.equal(a[0][k], b[0][k]) for k in a[0])
            and a[1] == b[1] and len(a[2]) == len(b[2])
            and all(torch.equal(x, y) for x, y in zip(a[2] + a[3], b[2] + b[3])))


def counted_eval(kernels, rows, cfg, model, loader, test_set, out_dir, label, launched,
                 n_batches, library=library_three_nn):
    """One ``eval_one_epoch`` with the counts set to 0 just before and read
    just after, every kernel call captured; each kernel in `launched` must
    launch, no other. B1's calls (NMS, the recall counter, the evaluator)
    and the first batch's calls of the other kernels are held against the
    plain versions and timed (the `label`_* keys of `rows`). Returns (the
    result dict, the launches, B1's calls by entry point)."""
    from fv2p_torch.ops import cuda as kcuda
    from fv2p_torch.tools import eval_utils
    cap = copy_kernels(kernels)
    kcuda.reset_launch_counts()
    with patched(cap, capturing):
        ret, _ = eval_utils.eval_one_epoch(cfg, model, loader, test_set, out_dir,
                                           quiet_logger(), KITTI_BATCH)
    sync()
    launches = dict(kcuda.launch_counts)
    for name, n in launches.items():
        if (name in launched) != (n > 0):
            fail(f'{label}: kernel {name} launched {n} times over the val set; '
                 f'the path launches {sorted(launched)}')
    for k in cap:
        if launches[k.name] != len(k.calls):
            fail(f'{label} {k.name}: {launches[k.name]} launches, {len(k.calls)} calls')
        if k.name != 'rotated_iou':
            k.calls = k.calls[:launches[k.name] // n_batches]
    b1 = next(k for k in cap if k.name == 'rotated_iou')
    b1_calls = {fn: sum(1 for c in b1.calls if c[0] == fn) for fn in b1.entries}
    log(f'# {label}: launches over {n_batches} batches {launches} (B1 with the recall '
        f'counter and the evaluator: {b1_calls})')
    train_kernel_rows({k.name: k for k in cap}, launches, rows, prefix=label, library=library)
    return ret, launches, b1_calls


def kitti_eval_phase(kernels, rows, cfg, label, launched, calibrate=False):
    """``eval_one_epoch`` over the 24 val scans of data/kitti at the test cap
    (batch 4, 4 spawned loader workers, bf16, seeded weights; with
    `calibrate` the BatchNorm statistics are set on the first batch, as
    MGAF needs). The first run is ``counted_eval``'s, with `launched`;
    the second gives the times, recall and AP. Returns (record, model, first batch on the card, dataset, det_annos,
    AP dict)."""
    from fv2p_torch.datasets import batch_to_numpy, build_dataloader, dataset_meta_from_cfg
    from fv2p_torch.tools import eval_utils
    from fv2p_torch.tools import test as test_runner
    from fv2p_torch.utils.synthetic import batch_to_torch
    logger = quiet_logger()
    test_set = test_runner.make_dataset(cfg, training=False, logger=logger)
    loader = build_dataloader(test_set, KITTI_BATCH, KITTI_WORKERS, training=False,
                              pin_memory=True)
    t0 = time.perf_counter()
    batches = [batch_to_numpy(b) for b in loader]       # starts the workers
    rec = {'scans': len(test_set), 'batches': len(batches),
           'first_pass_s': time.perf_counter() - t0,
           'voxels_per_scan': np.concatenate([b['voxel_valid'].sum(1) for b in batches]).tolist(),
           'voxel_cap': int(batches[0]['voxel_valid'].shape[1])}
    if 'points_valid' in batches[0]:
        rec['points_per_scan'] = np.concatenate(
            [b['points_valid'].sum(1) for b in batches]).tolist()
        rec['points_cap'] = int(batches[0]['points_valid'].shape[1])
    first_np, _ = eval_utils.pad_batch_to_size(batches[0], KITTI_BATCH)
    first = batch_to_torch(first_np, 'cuda')
    meta = dataset_meta_from_cfg(cfg.DATA_CONFIG, 'test')
    model = make_model(cfg, meta, torch.bfloat16, calibrate_on=first if calibrate else None)
    out_dir = REPO / 'output' / 'chip_smoke' / label
    out_dir.mkdir(parents=True, exist_ok=True)

    ret_a, rec['launches'], rec['b1_calls'] = counted_eval(
        kernels, rows, cfg, model, loader, test_set, out_dir, label, launched, len(batches))
    rec['launches_per_batch'] = {n: v / len(batches) for n, v in rec['launches'].items()}

    ret, annos = eval_utils.eval_one_epoch(cfg, model, loader, test_set, out_dir, logger,
                                           KITTI_BATCH)
    rec['result'] = ret
    rec['recall'] = {k: v for k, v in ret.items() if k.startswith('recall/')}
    rec['ap'] = {k: v for k, v in ret.items() if '/' in k and not k.startswith('recall/')}
    for key in ('sec_per_example', 'sec_per_example_first_batch', 'loader_wait_s_per_batch',
                'forward_ms_median'):
        rec[key] = ret[key]
    vox = np.array(rec['voxels_per_scan'])
    log(f'# {label}: {ret["sec_per_example"] * 1e3:.2f} ms a scan through the runner '
        f'(first batch apart; the first batch {ret["sec_per_example_first_batch"] * 1e3:.2f}), '
        f'forward median {ret["forward_ms_median"]:.2f} ms a batch of {KITTI_BATCH}, '
        f'loader wait {ret["loader_wait_s_per_batch"] * 1e3:.2f} ms a batch; voxels a scan '
        f'{int(vox.min())}-{int(vox.max())} (mean {vox.mean():.0f}) of {rec["voxel_cap"]}'
        + (f', points a scan {min(rec["points_per_scan"])}-{max(rec["points_per_scan"])} '
           f'of {rec["points_cap"]}' if 'points_per_scan' in rec else ''))
    log(f'# {label} recall: {rec["recall"]}')
    log(f'# {label} AP (seeded weights): {rec["ap"]}')
    for k in (ret_a, ret):
        if any(not np.isfinite(v) for v in k.values()):
            fail(f'{label}: a result is not finite: {k}')
    del loader
    return rec, model, first, first_np, test_set, annos, ret


def kitti_eval_f32(kernels, cfg, test_set, first, first_np):
    """One val batch in f32 without TF32 through the kernels and through the
    plain versions, forward, recall counter and prediction dicts: names and
    counts identical, floats within KITTI_F32_ATOL."""
    from fv2p_torch.datasets import dataset_meta_from_cfg
    from fv2p_torch.tools import eval_utils
    meta = dataset_meta_from_cfg(cfg.DATA_CONFIG, 'test')
    recall_fn = eval_utils.make_recall_fn(tuple(cfg.MODEL.POST_PROCESSING.RECALL_THRESH_LIST))

    def run(model):
        out = forward(model, first)
        pred = {k: out[k].float().cpu().numpy() if out[k].is_floating_point()
                else out[k].cpu().numpy() for k in eval_utils.PRED_KEYS}
        counts = recall_fn(out['pred_boxes'], out['pred_valid'], first['gt_boxes'],
                           out.get('rois'))
        return test_set.generate_prediction_dicts(first_np, pred, cfg.CLASS_NAMES), counts

    with full_f32():
        model32 = make_model(cfg, meta, None)
        annos_k, counts_k = run(model32)
        with patched(kernels, plain_route):
            annos_p, counts_p = run(model32)
    worst = 0.0
    for ak, ap in zip(annos_k, annos_p):
        if list(ak['name']) != list(ap['name']):
            fail('kitti_eval f32: detections differ between kernels and plain versions')
        for key in ('bbox', 'dimensions', 'location', 'rotation_y', 'score', 'alpha',
                    'boxes_lidar'):
            if ak[key].size:
                worst = max(worst, float(np.abs(ak[key] - ap[key]).max()))
    if worst > KITTI_F32_ATOL:
        fail(f'kitti_eval f32: det_annos differ by {worst} > {KITTI_F32_ATOL}')
    for a, b in zip(counts_k[:2], counts_p[:2]):
        if not np.array_equal(a, b):
            fail(f'kitti_eval f32: recall counts differ: {counts_k} vs {counts_p}')
    n = sum(len(a['name']) for a in annos_k)
    log(f'# kitti_eval f32 batch, kernels vs plain versions: {n} detections, names '
        f'identical, max abs difference {worst}; recall counts {counts_k[0].tolist()} '
        f'(final) {counts_k[1].tolist()} (RoIs) of {counts_k[2]} gt, identical')
    del model32
    torch.cuda.empty_cache()
    return {'detections': n, 'max_abs_diff': worst, 'recall_counts': counts_k[0].tolist(),
            'roi_recall_counts': counts_k[1].tolist(), 'gt': counts_k[2]}


def kitti_evaluator_phase(test_set, annos, ap_kernel):
    """The val ground truth scored against itself as detections (score 1)
    on the card, and the kitti_eval run's AP dict recomputed with B1's plain
    version on the CPU: equal key for key."""
    import copy
    from fv2p_torch.datasets.kitti.kitti_object_eval import eval as kitti_eval
    from fv2p_torch.ops import cuda as kcuda
    gt = [copy.deepcopy(info['annos']) for info in test_set.kitti_infos]
    dets = []
    for g in gt:
        keep = g['name'] != 'DontCare'
        d = {k: g[k][keep] for k in ('name', 'truncated', 'occluded', 'alpha', 'bbox',
                                     'dimensions', 'location', 'rotation_y')}
        d['score'] = np.ones(int(keep.sum()))
        dets.append(d)
    kcuda.reset_launch_counts()
    _, ret = kitti_eval.get_official_eval_result(copy.deepcopy(gt), dets, ['Car'],
                                                 device='cuda')
    sync()
    launches = kcuda.launch_counts['rotated_iou']
    if launches == 0:
        fail('kitti_evaluator: B1 was not launched')
    # the official 41-point recall sampling: with n valid gt boxes of a
    # difficulty, AP_R40 of perfect detections is 100 (min(n, 41) - 1) / 40
    rec = {'b1_launches': launches, 'car_3d_r40': {}, 'expected': {}, 'valid_gt': {}}
    for d, diff in enumerate(('easy', 'moderate', 'hard')):
        n = sum(kitti_eval.clean_data(g, dt, 0, d)[0] for g, dt in zip(gt, dets))
        want = 100.0 * (min(n, 41) - 1) / 40
        got = ret[f'Car_3d/{diff}_R40']
        rec['car_3d_r40'][diff], rec['expected'][diff], rec['valid_gt'][diff] = got, want, n
        if abs(got - want) > 1e-9:
            fail(f'kitti_evaluator: Car 3D AP_R40 {diff} {got}, expected {want} ({n} gt)')
    log(f'# kitti_evaluator: the val gt as detections, Car 3D AP_R40 '
        f'{rec["car_3d_r40"]} with {rec["valid_gt"]} valid gt boxes (perfect detections '
        f'give 100 (min(n, 41) - 1) / 40); B1 launched {launches} times')
    _, ap_plain = test_set.evaluation(annos, ['Car'], device='cpu')
    ap_plain = {k: float(v) for k, v in ap_plain.items()}
    ap_kernel = {k: v for k, v in ap_kernel.items() if k in ap_plain}
    if ap_plain != ap_kernel:
        diff = {k: (ap_kernel.get(k), v) for k, v in ap_plain.items() if ap_kernel.get(k) != v}
        fail(f'kitti_evaluator: the AP dict differs between B1 on the card and its plain '
             f'version on the CPU: {diff}')
    rec['plain_cpu_ap_equal'] = True
    log(f'# kitti_evaluator: the kitti_eval AP dict ({len(ap_plain)} keys) is the same '
        f'with B1 on the card and with its plain version on the CPU')
    return rec


def host_batch_seconds(train_set, n_batches):
    """Host seconds a train batch (KITTI_TRAIN_BATCH scans, augmentation and
    rulebooks, collated) takes in this process, with the C++ rulebook
    builder and with the numpy one, and the overflow counters of those
    samples."""
    from fv2p_torch.ops.sparse import host_rulebook
    out = {}
    host_rulebook.reset_overflow_stats()
    for route in ('cpp', 'numpy'):
        train_set.rng = np.random.RandomState(SEED)
        saved = host_rulebook.build_sample_rulebooks
        if route == 'numpy':
            host_rulebook.build_sample_rulebooks = host_rulebook.build_sample_rulebooks_plain
        try:
            t0 = time.perf_counter()
            for i in range(n_batches):
                idx = range(i * KITTI_TRAIN_BATCH, (i + 1) * KITTI_TRAIN_BATCH)
                train_set.collate_batch([train_set[j] for j in idx])
            out[route] = (time.perf_counter() - t0) / n_batches
        finally:
            host_rulebook.build_sample_rulebooks = saved
    out['overflow'] = host_rulebook.get_overflow_stats()
    return out


def kitti_train_phase(kernels, rows, cfg):
    """``fv2p_torch.tools.train`` on the 32 train scans: fv2p.yaml, bf16,
    batch 2, full augmentation with gt sampling, the yaml's train level
    capacities, 4 spawned loader workers, the peak learning rate at
    KITTI_TRAIN_LR. One epoch (16 steps) and its
    checkpoint; then the runner again for 2 epochs with
    --max_ckpt_save_num 1: it must resume from that file with the saved
    parameters, optimizer state and one-cycle step bit for bit, take the
    second epoch and leave one checkpoint. Each run is counted (B1, B2, B3
    launch, B4 does not); every loss term of every step must be finite."""
    import shutil
    from fv2p_torch.ops import cuda as kcuda
    from fv2p_torch.tools import test as test_runner
    from fv2p_torch.tools import train as train_runner
    out = REPO / 'output' / 'chip_smoke' / 'kitti_train'
    shutil.rmtree(out, ignore_errors=True)
    argv = ['--cfg_file', str(CFG), '--batch_size', str(KITTI_TRAIN_BATCH),
            '--workers', str(KITTI_WORKERS), '--output_dir', str(out)]
    # the yaml's peak learning rate over a two-epoch one-cycle schedule
    # drives the seeded bf16 model past overflow in the second epoch
    # (background RoIs' box codes; ROADMAP.md C3): a tenth of it here
    lr = ['--set', 'OPTIMIZATION.LR', str(KITTI_TRAIN_LR)]
    launched = ('rotated_iou', 'fps', 'three_nn')

    def counted(extra, on_resume=None):
        kcuda.reset_launch_counts()
        t0 = time.perf_counter()
        run = train_runner.main(argv + extra, on_resume=on_resume)
        sync()
        run['wall_s'] = time.perf_counter() - t0
        run['launches'] = dict(kcuda.launch_counts)
        for name, n in run['launches'].items():
            if (name in launched) != (n > 0):
                fail(f'kitti_train: kernel {name} launched {n} times in '
                     f'{len(run["steps"])} steps; the path launches {launched}')
        return run

    first = counted(['--epochs', '1'] + lr)
    ckpt_dir = out / 'ckpt'
    names = [p.name for _, p in test_runner.checkpoint_list(ckpt_dir)]
    if names != ['checkpoint_epoch_1.pth']:
        fail(f'kitti_train: after one epoch the checkpoints are {names}')
    live = state_of(first.pop('trainer'))
    saved = saved_state(ckpt_dir / 'checkpoint_epoch_1.pth')
    if not states_equal(live, saved):
        fail('kitti_train: the checkpoint differs from the trainer that wrote it')
    del saved
    resumed = {}

    def on_resume(trainer, path):
        resumed['path'] = path
        resumed['equal'] = states_equal(state_of(trainer), live)
        resumed['step'] = trainer.step_count

    second = counted(['--epochs', '2', '--max_ckpt_save_num', '1'] + lr, on_resume=on_resume)
    second.pop('trainer')
    del live
    torch.cuda.empty_cache()
    if resumed.get('path') is None or resumed['path'].name != 'checkpoint_epoch_1.pth':
        fail(f'kitti_train: the second run did not resume from epoch 1: {resumed}')
    if not resumed['equal']:
        fail('kitti_train: the resumed state differs from the saved one')
    names = [p.name for _, p in test_runner.checkpoint_list(ckpt_dir)]
    if names != ['checkpoint_epoch_2.pth']:
        fail(f'kitti_train: with --max_ckpt_save_num 1 the checkpoints are {names}')
    steps = first['steps'] + second['steps']
    if len(first['steps']) != 16 or len(second['steps']) != 16:
        fail(f'kitti_train: {len(first["steps"])} + {len(second["steps"])} steps, expected 16 + 16')
    bad = [(s['it'], k) for s in steps for k, v in s.items() if not np.isfinite(v)]
    if bad:
        fail(f'kitti_train: non-finite loss terms (step, term): {bad}')
    # the first step of each run waits for the spawned workers' first batch
    step_ms = np.array(first['step_s'][1:] + second['step_s'][1:]) * 1e3
    wait_ms = np.array(first['loader_wait_s'][1:] + second['loader_wait_s'][1:]) * 1e3
    q1, med, q3 = (float(x) for x in np.percentile(step_ms, [25, 50, 75]))
    rec = {'steps': len(steps), 'resumed_from_step': resumed['step'],
           'resume_bit_for_bit': True, 'checkpoints_left': names,
           'step_ms': {'median': med, 'q1': q1, 'q3': q3, 'all': step_ms.tolist()},
           'loader_wait_ms': {'mean': float(wait_ms.mean()), 'median': float(np.median(wait_ms)),
                              'max': float(wait_ms.max())},
           'first_step_s': [first['step_s'][0], second['step_s'][0]],
           'run_wall_s': [first['wall_s'], second['wall_s']],
           'launches': [first['launches'], second['launches']],
           'loss': [s['loss'] for s in steps]}
    for row in rows:
        row['kitti_train_launches'] = first['launches'][row['name']] + \
            second['launches'][row['name']]
    log(f'# kitti_train: 16 + 16 steps at batch {KITTI_TRAIN_BATCH} across a restart '
        f'(resumed at step {resumed["step"]}, bit for bit; checkpoints left {names}); '
        f'step through the runner {med:.2f} ms median ({q1:.2f}-{q3:.2f}, loader wait '
        f'included), loader wait {wait_ms.mean():.2f} ms a step (median '
        f'{np.median(wait_ms):.2f}, max {wait_ms.max():.2f}); first steps '
        f'{[round(x, 2) for x in rec["first_step_s"]]} s; launches {rec["launches"]}')
    log(f'# kitti_train loss per step: {[round(x, 3) for x in rec["loss"]]}')
    train_set = test_runner.make_dataset(cfg, training=True, logger=quiet_logger())
    rec['host_s_per_batch'] = host_batch_seconds(train_set, 3)
    hs = rec['host_s_per_batch']
    log(f'# kitti_train host seconds a batch of {KITTI_TRAIN_BATCH} in one process: '
        f'{hs["cpp"]:.3f} with the C++ rulebook builder, {hs["numpy"]:.3f} with the '
        f'numpy one; rulebook overflow counters {hs["overflow"]}')
    return rec


# ------------------------------------------------------ device rulebooks

def library_three_nn_chunked(call, chunk=4096):
    """torch.cdist + topk in query chunks: a batch-flat level's whole
    (B, M, N) distance matrix would take tens of GiB."""
    src, valid, q = call[1]
    offset = torch.where(valid, 0.0, 1e10)[:, None, :]
    return [torch.topk(torch.cdist(q[:, i:i + chunk], src) ** 2 + offset, 3, dim=-1,
                       largest=False) for i in range(0, q.shape[1], chunk)]


def device_batch(batch_np, seed):
    """The batch as the loader ships it with --rulebooks device: no tables,
    each scan's valid voxels in a shuffled order."""
    rng = np.random.RandomState(seed)
    out = {k: v.copy() for k, v in batch_np.items() if k != 'rulebooks'}
    for b in range(out['voxel_valid'].shape[0]):
        n = int(out['voxel_valid'][b].sum())
        perm = rng.permutation(n)
        for key in ('voxels', 'voxel_coords', 'voxel_num_points'):
            out[key][b, :n] = out[key][b, :n][perm]
    return out


def rulebooks_of(model, batch, device_mode):
    """The backbone's levels and tables for one batch, host or device."""
    from fv2p_torch.models.backbones_3d.spconv_backbone import Rulebooks
    bd = model.vfe(dict(batch))
    bb = model.backbone_3d
    if device_mode:
        return Rulebooks.on_device(bd, bb.shapes, bb.level_caps, bb.training)
    return Rulebooks.from_host(bd, bb.shapes)


def compare_rulebooks(hst, dev, batch_size):
    """Per level and sample, the device tables' valid rows equal the host
    builder's; the device tables, mapped to the host's per-sample rows,
    equal the host tables. Returns {level: rows per sample}."""
    from fv2p_torch.models.backbones_3d.spconv_backbone import LEVELS
    levels = {'x_conv1': (hst.input, dev.input)}
    levels.update({lvl: (hst.down[lvl][0], dev.down[lvl][0]) for lvl in hst.down})
    maps, counts = {}, {}
    for lvl, (h, d) in levels.items():
        hv, dv = h.valid_mask(), d.valid_mask()
        per_h = torch.bincount(h.coords()[hv, 0], minlength=batch_size)
        per_d = torch.bincount(d.coords()[dv, 0], minlength=batch_size)
        if not torch.equal(per_h, per_d):
            fail(f'device_rulebooks {lvl}: rows per sample {per_d.tolist()}, host '
                 f'{per_h.tolist()}')
        if not torch.equal(d.keys[dv], h.keys[hv]):
            fail(f'device_rulebooks {lvl}: the voxels differ from the host builder\'s')
        m = torch.full((h.capacity + 1,), d.capacity, dtype=torch.int64, device=hv.device)
        m[torch.nonzero(hv)[:, 0]] = torch.nonzero(dv)[:, 0]
        maps[lvl], counts[lvl] = m, per_h.tolist()
    for lvl in hst.subm:
        hv = levels[lvl][0].valid_mask()
        if not torch.equal(dev.subm[lvl][maps[lvl][:-1][hv]], maps[lvl][hst.subm[lvl][hv]]):
            fail(f'device_rulebooks: the submanifold table of {lvl} differs from the host\'s')
    srcs = dict(zip(LEVELS[1:], LEVELS[:-1]))
    for dst, (h_out, h_nbr, h_inv) in hst.down.items():
        _, d_nbr, d_inv = dev.down[dst]
        hv, hs = h_out.valid_mask(), levels[srcs[dst]][0].valid_mask()
        if not torch.equal(d_nbr[maps[dst][:-1][hv]], maps[srcs[dst]][h_nbr[hv]]):
            fail(f'device_rulebooks: the gather table of {dst} differs from the host\'s')
        if not torch.equal(d_inv[maps[srcs[dst]][:-1][hs]], maps[dst][h_inv[hs]]):
            fail(f'device_rulebooks: the inverse table into {dst} differs from the host\'s')
    return counts


def modes_f32(cfg, meta, batch_h, batch_d, label, calibrate=False):
    """One f32 forward (no TF32) from the same weights on the host-table
    batch and on the device-mode batch. The sparse trunk's BEV map
    (``spatial_features``, all the rulebook mode touches) within F32_ATOL;
    the detections the same (valid flags and labels identical, boxes and
    scores within F32_ATOL). MGAF's DCNs multiply rounding by ~1e3 on the way
    from the BEV map to the heat map, so that two neighbouring peaks within
    rounding of each other change places (``calibrate``, its seeded and
    calibrated weights): there a control sets the limit, host mode alone
    from the host BEV map with a relative perturbation of 1e-6. Valid flags
    and labels must still be identical, and each of the box and score
    differences at most CONTROL_FACTOR times the control's."""
    with full_f32():
        model32 = make_model(cfg, meta, None, batch_h if calibrate else None)
        out_h, out_d = forward(model32, batch_h), forward(model32, batch_d)
        sync()
    if int(out_d['rulebook_overflow'].sum()) != 0:
        fail(f'{label} f32: device rulebooks dropped rows {out_d["rulebook_overflow"].tolist()}')
    bev_diff = float((out_h['spatial_features'] - out_d['spatial_features']).abs().max())
    if bev_diff > F32_ATOL:
        fail(f'{label} f32: the BEV maps of host and device rulebooks part by {bev_diff}')

    def pred_diffs(a, b):
        valid = a['pred_valid'] & b['pred_valid']
        return {k: float((a[k][valid] - b[k][valid]).abs().max()) if valid.any() else 0.0
                for k in ('pred_boxes', 'pred_scores')}

    diffs = pred_diffs(out_h, out_d)
    same = all(torch.equal(out_h[k], out_d[k]) for k in ('pred_valid', 'pred_labels'))
    rec = {'bev_max_abs_diff': bev_diff, 'bev_max_abs': float(out_h['spatial_features'].abs().max()),
           'detections': int(out_h['pred_valid'].sum()),
           'detections_device': int(out_d['pred_valid'].sum()),
           'keeps_and_labels_identical': same, 'max_abs_diff': diffs}
    if not calibrate:
        if not same:
            fail(f'{label} f32: keeps or labels differ between host and device rulebooks')
        if max(diffs.values()) > F32_ATOL:
            fail(f'{label} f32: host and device rulebooks part by {diffs} > {F32_ATOL}')
    else:
        gen = torch.Generator(device='cuda').manual_seed(SEED)
        with full_f32(), torch.no_grad():
            sf = out_h['spatial_features']
            bd = {'spatial_features': sf * (1 + 1e-6 * torch.randn(sf.shape, generator=gen,
                                                                    device=sf.device)),
                  'spatial_features_stride': out_h['spatial_features_stride']}
            bd = model32.dense_head(model32.backbone_2d(bd))
            control = model32.final_predictions(bd)
        rec['control_max_abs_diff'] = pred_diffs(out_h, control)
        rec['control_keeps_and_labels_identical'] = all(
            torch.equal(out_h[k], control[k]) for k in ('pred_valid', 'pred_labels'))
        if not same:
            fail(f'{label} f32: keeps or labels differ between host and device rulebooks')
        limit = {k: CONTROL_FACTOR * v for k, v in rec['control_max_abs_diff'].items()}
        if any(diffs[k] > limit[k] for k in diffs):
            fail(f'{label} f32: host and device rulebooks part by {diffs}, more than '
                 f'{CONTROL_FACTOR} x the control\'s {rec["control_max_abs_diff"]}')
    log(f'# {label} f32, host vs device rulebooks: BEV maps within {bev_diff:.3g} '
        f'(of {rec["bev_max_abs"]:.3g}); {rec["detections"]} / {rec["detections_device"]} '
        f'detections, keeps and labels identical: {same}, max abs difference {diffs}'
        + (f'; control (host BEV map x (1 + 1e-6 N(0, 1))): identical '
           f'{rec["control_keeps_and_labels_identical"]}, {rec["control_max_abs_diff"]}'
           if calibrate else ''))
    del model32
    torch.cuda.empty_cache()
    return rec


def counted_forward(kernels, model, batch, label, launched):
    """One forward with the counts set to 0 just before and read just after;
    every kernel call captured. Each kernel in `launched` must launch, no
    other. Returns (output, {name: Kernel with its calls}, launches)."""
    from fv2p_torch.ops import cuda as kcuda
    cap = copy_kernels(kernels)
    kcuda.reset_launch_counts()
    with patched(cap, capturing):
        out = forward(model, batch)
    sync()
    launches = dict(kcuda.launch_counts)
    for k in cap:
        if (k.name in launched) != (launches[k.name] > 0):
            fail(f'{label}: kernel {k.name} launched {launches[k.name]} times; the path '
                 f'launches {sorted(launched)}')
        if launches[k.name] != len(k.calls):
            fail(f'{label} {k.name}: {launches[k.name]} launches, {len(k.calls)} calls')
    log(f'# {label} main path launches: {launches}')
    return out, {k.name: k for k in cap}, launches


def device_rulebooks_phase(kernels, rows, cfg, mcfg, meta, batch_np, model, mgaf, record,
                           mrec):
    """FV2P and MGAF-3DSSD with --rulebooks device on the bench batch: the
    voxels shuffled per scan, no tables. The device tables against the host
    builder's, the f32 detections of both modes, B3's batch-mixed calls
    against the plain version, the builder's time and host waits, the bf16
    forwards of both modes and their peak memory. Returns (record, the
    builder's closure for the profiler)."""
    from fv2p_torch.utils.synthetic import batch_to_torch
    batch_h = batch_to_torch(batch_np, 'cuda')
    batch_d = batch_to_torch(device_batch(batch_np, SEED + 1), 'cuda')
    rec = {}
    with torch.no_grad():
        hst, dev = rulebooks_of(model, batch_h, False), rulebooks_of(model, batch_d, True)
    rec['rows_per_sample'] = compare_rulebooks(hst, dev, BATCH)
    rec['overflow'] = dev.overflow.tolist()
    if any(rec['overflow']):
        fail(f'device_rulebooks: rows dropped at x_conv2..out: {rec["overflow"]}')
    rec['level_capacity'] = {lvl: int(dev.down[lvl][0].capacity) for lvl in dev.down}
    log(f'# device_rulebooks: every level\'s rows per sample equal the host builder\'s '
        f'{rec["rows_per_sample"]}; the tables mapped to per-sample rows equal the host\'s; '
        f'nothing dropped (capacities {rec["level_capacity"]})')
    del hst, dev

    bd_d = model.vfe(dict(batch_d))
    bb = model.backbone_3d

    def build():
        from fv2p_torch.models.backbones_3d.spconv_backbone import Rulebooks
        return Rulebooks.on_device(bd_d, bb.shapes, bb.level_caps, False)

    with torch.no_grad():
        rec['builder_ms'] = time_events(build, reps=10)
        _, rec['builder_host_sync_sites'] = host_syncs(build)
    # the sites in the port's code: host_syncs' own closing synchronise is
    # torch's
    own = {k: v for k, v in rec['builder_host_sync_sites'].items()
           if k.startswith('fv2p_torch')}
    rec['builder_host_syncs'] = sum(own.values())
    if own:
        fail(f'device_rulebooks: the builder waits for the card '
             f'{rec["builder_host_syncs"]} times: {own}')
    log(f'# device_rulebooks: the builder takes {rec["builder_ms"]:.3f} ms a forward '
        f'(CUDA events, batch {BATCH}) and makes no host wait')

    rec['fv2p_f32'] = modes_f32(cfg, meta, batch_h, batch_d, 'fv2p device_rulebooks')
    rec['mgaf_f32'] = modes_f32(mcfg, meta, batch_h, batch_d, 'mgaf device_rulebooks',
                                calibrate=True)

    out, calls, launches = counted_forward(
        kernels, model, batch_d, 'fv2p device_rulebooks',
        ('rotated_iou', 'fps', 'three_nn', 'sa_group'))
    check_outputs(out, int(cfg.MODEL.POST_PROCESSING.NMS_CONFIG.NMS_POST_MAXSIZE), FV2P_KEYS)
    del out
    b3 = calls['three_nn']
    rec['b3_source_rows'] = [int(c[1][0].shape[1]) for c in b3.calls]
    # B1, B2 and B4 see the inputs of host mode: only B3's calls are replayed
    others = {k.name: k for k in copy_kernels(kernels) if k.name != 'three_nn'}
    train_kernel_rows({'three_nn': b3, **others}, launches, rows, prefix='device_rulebooks',
                      library=library_three_nn_chunked)
    b3_row = next(r for r in rows if r['name'] == 'three_nn')
    log(f'# device_rulebooks: B3 on the batch-mixed levels (sources {rec["b3_source_rows"]} '
        f'rows, four samples wide) {b3_row["device_rulebooks_ms"]:.3f} ms against '
        f'{b3_row["ms"]:.3f} ms on the host tables\' per-sample blocks')
    del calls, b3

    rec['fv2p'] = forward_stats(model, batch_d, 'fv2p device_rulebooks')
    rec['mgaf'] = forward_stats(mgaf, batch_d, 'mgaf device_rulebooks')
    rec['fv2p_host_forward_ms'] = record['forward_ms']['median']
    rec['mgaf_host_forward_ms'] = mrec['forward_ms']['median']
    # device memory a forward takes beyond what is resident, both modes here
    rec['forward_extra_gib'] = {}
    for name, m in (('fv2p', model), ('mgaf', mgaf)):
        for mode, bt in (('host', batch_h), ('device', batch_d)):
            sync()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            forward(m, bt)
            sync()
            rec['forward_extra_gib'][f'{name}_{mode}'] = (
                torch.cuda.max_memory_allocated() - base) / 2 ** 30
    log(f'# device_rulebooks: device memory one forward takes beyond the resident '
        f'(GiB): {rec["forward_extra_gib"]}')
    return rec, build


# ------------------------------------------------ SECOND and PointPillar

SECOND_CFG = REPO / 'tools' / 'cfgs' / 'kitti_models' / 'second.yaml'
PILLAR_CFG = REPO / 'tools' / 'cfgs' / 'kitti_models' / 'pointpillar.yaml'
SECOND_MH_CFG = REPO / 'tools' / 'cfgs' / 'kitti_models' / 'second_multihead.yaml'


def pillar_batch(points, meta, cap):
    """Pillars of each scan's points through the port's voxel generator
    (pointpillar.yaml's 0.16 x 0.16 x 4 m pillars, MAX_POINTS_PER_VOXEL),
    padded to `cap` rows."""
    from fv2p_torch.datasets.processor.voxel_generator import VoxelGenerator
    gen = VoxelGenerator(meta['voxel_size'], meta['point_cloud_range'],
                         meta['max_points_per_voxel'], cap)
    b, p = points.shape[0], meta['max_points_per_voxel']
    out = {'voxels': np.zeros((b, cap, p, points.shape[-1]), np.float32),
           'voxel_coords': np.zeros((b, cap, 3), np.int32),
           'voxel_num_points': np.zeros((b, cap), np.int32),
           'voxel_valid': np.zeros((b, cap), bool)}
    for i in range(b):
        v, c, n = gen.generate(points[i])
        k = len(c)
        out['voxels'][i, :k], out['voxel_coords'][i, :k] = v, c
        out['voxel_num_points'][i, :k], out['voxel_valid'][i, :k] = n, True
    return out


def zoo_batches(zcfg, batch_np, train_np):
    """(eval batch, train batch) on the card for a SECOND yaml (the bench
    voxels, no tables) or a PointPillar yaml (pillars of the same scans'
    points)."""
    from fv2p_torch.datasets import dataset_meta_from_cfg
    from fv2p_torch.utils.synthetic import batch_to_torch
    if zcfg.MODEL.VFE.NAME != 'PillarVFE':
        keep = ('voxels', 'voxel_coords', 'voxel_num_points', 'voxel_valid')
        ev = {k: batch_np[k] for k in keep}
        tr = {k: train_np[k] for k in keep + ('gt_boxes',)}
    else:
        ev = pillar_batch(batch_np['points'], dataset_meta_from_cfg(zcfg.DATA_CONFIG, 'test'),
                          40000)
        tr = pillar_batch(train_np['points'],
                          dataset_meta_from_cfg(zcfg.DATA_CONFIG, 'train'), 16000)
        tr['gt_boxes'] = train_np['gt_boxes']
    return batch_to_torch(ev, 'cuda'), batch_to_torch(tr, 'cuda')


def nms_lanes(zcfg):
    """Detection slots a scan and NMS lanes a scan of a cls-score model:
    NMS_POST_MAXSIZE slots in one lane, or in one lane a class with
    MULTI_CLASSES_NMS."""
    nms = zcfg.MODEL.POST_PROCESSING.NMS_CONFIG
    lanes = len(zcfg.CLASS_NAMES) if nms.get('MULTI_CLASSES_NMS', False) else 1
    return lanes * int(nms.NMS_POST_MAXSIZE), lanes


def lane_candidates(zcfg, out, shift=0.0):
    """Anchors above SCORE_THRESH in each (scan, class) lane, with the class
    logits less `shift`: (B, C) list."""
    probs = torch.sigmoid(out['batch_cls_preds'].float() - shift)
    return (probs >= float(zcfg.MODEL.POST_PROCESSING.SCORE_THRESH)).sum(1).tolist()


def zoo_phase(kernels, rows, label, zcfg, batch, tbatch, later, cls_shift=0.0):
    """One cls-score yaml at full width: the bf16 forward at batch 4
    (median, per module, peak memory, host waits), counted (B1 only) with
    its calls held against the plain version and timed, the f32 forward
    through the kernels against the plain versions; then train steps at the
    yaml's batch: an f32 step through the kernels and through the plain
    versions, 2 + 5 bf16 steps with every loss term finite, the loss
    falling and no kernel launched. B1 with its calls is appended to
    `later` as (label, kernel), for its device time under the profiler at
    the end; `cls_shift` raises the eval model's class logits
    (``make_model``). Returns the record."""
    from fv2p_torch.datasets import dataset_meta_from_cfg
    from fv2p_torch.ops import cuda as kcuda
    meta = dataset_meta_from_cfg(zcfg.DATA_CONFIG, 'test')
    rec = {'voxels_per_scan': batch['voxel_valid'].sum(1).tolist(),
           'voxel_cap': int(batch['voxel_valid'].shape[1])}
    model = make_model(zcfg, meta, torch.bfloat16, calibrate_on=batch, cls_shift=cls_shift)
    rec['parameters'] = sum(p.numel() for p in model.parameters())
    post, rec['nms_lanes_per_scan'] = nms_lanes(zcfg)
    out, calls, launches = counted_forward(kernels, model, batch, label, ('rotated_iou',))
    rec['valid_detections'] = check_outputs(out, post, ('batch_box_preds', 'batch_cls_preds'))
    rec['launches'] = launches
    rec['candidates_per_lane'] = lane_candidates(zcfg, out)
    if cls_shift:
        rec['candidates_per_lane_unshifted'] = lane_candidates(zcfg, out, cls_shift)
        log(f'# {label}: anchors above SCORE_THRESH per lane with the class logits '
            f'{cls_shift} lower: {rec["candidates_per_lane_unshifted"]}')
    log(f'# {label}: {rec["parameters"]} parameters, {rec["valid_detections"]} valid '
        f'detections over {BATCH} scans ({rec["voxels_per_scan"]} voxels of '
        f'{rec["voxel_cap"]} a scan); anchors above SCORE_THRESH per (scan, class) lane: '
        f'{rec["candidates_per_lane"]}')
    del out
    train_kernel_rows(calls, launches, rows, prefix=label)
    later.append((label, calls['rotated_iou']))
    rec['f32_kernel_vs_plain_max_abs'] = f32_forward(
        kernels, zcfg, meta, batch, post, ('batch_box_preds', 'batch_cls_preds'), label,
        ('pred_boxes', 'pred_scores', 'batch_box_preds', 'batch_cls_preds'), calibrate=True,
        cls_shift=cls_shift)
    rec.update(forward_stats(model, batch, label))
    rec['host_syncs'], rec['host_sync_sites'] = host_syncs(lambda: forward(model, batch))
    log(f'# {label} host waits in one forward: {rec["host_syncs"]}; by line: '
        f'{rec["host_sync_sites"]}')
    del model
    torch.cuda.empty_cache()

    tmeta = dataset_meta_from_cfg(zcfg.DATA_CONFIG, 'train')
    rec['train_batch'] = int(zcfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)
    if rec['train_batch'] != tbatch['voxels'].shape[0]:
        fail(f'{label}: the train batch holds {tbatch["voxels"].shape[0]} scans, the yaml '
             f'{rec["train_batch"]}')
    with full_f32():
        step = make_train_step(zcfg, tmeta, None)
        tk, tg, _ = _zoo_f32_step(step, tbatch, None)
        tp, gp, _ = _zoo_f32_step(step, tbatch, kernels)
    rec['f32_kernel_vs_plain'] = compare_train_steps(f'{label} f32 step', tk, tp, tg, gp)
    del step
    torch.cuda.empty_cache()
    step = make_train_step(zcfg, tmeta, torch.bfloat16)
    trec = rec['train'] = timed_train_steps(kcuda, step, tbatch, (), lambda o: {
        'positive_anchors': int((o['anchor_head_ret']['box_cls_labels'] > 0).sum())})
    loss = trec['loss_terms']['loss']
    if not loss[-1] < loss[0]:
        fail(f'{label} train: the loss did not fall over {len(loss)} steps: {loss}')
    if trec['first_step_targets']['positive_anchors'] <= 0:
        fail(f'{label} train: no positive anchor in the first step')
    log(f'# {label} train bf16 step at batch {rec["train_batch"]}, ms median (quartiles) of '
        f'{TRAIN_TIMED}: ' + ', '.join(
            f'{k} {v["median"]:.2f} ({v["q1"]:.2f}-{v["q3"]:.2f})' for k, v in trec['ms'].items())
        + f'; peak {trec["peak_mem_gib"]:.2f} GiB; loss {[round(x, 3) for x in loss]}; '
        f'first step {trec["first_step_targets"]}')
    del step, batch, tbatch
    torch.cuda.empty_cache()
    return rec


def _zoo_f32_step(step, batch, kernels):
    """Loss terms, gradients and the forward's batch dict of one f32 step,
    through the plain versions when `kernels` is given; the weights are
    left as they were."""
    import copy
    state = copy.deepcopy(step.model.state_dict())
    with contextlib.ExitStack() as stack:
        if kernels is not None:
            stack.enter_context(patched(kernels, plain_route))
        loss, terms, out = step.forward_loss(batch)
        step.backward(loss)
    sync()
    step.model.load_state_dict(state)
    return {k: float(v.detach()) for k, v in terms.items()}, _grads(step.model), out


ATSS_ASSIGNER = {'NAME': 'ATSSTargetAssigner', 'TOPK': 9, 'MATCH_HEIGHT': False}
DEMO_SCAN = KITTI / 'training' / 'velodyne' / '000032.bin'   # the first val scan


def atss_targets(out):
    ret = out['anchor_head_ret']
    return {'positive_anchors': int((ret['box_cls_labels'] > 0).sum()),
            'positive_anchors_per_scan': (ret['box_cls_labels'] > 0).sum(1).tolist()}


def second_atss_phase(kernels, rows, tbatch):
    """kitti_models/second.yaml with TARGET_ASSIGNER_CONFIG set to
    ATSS_ASSIGNER, on the bench-kind train batch that `second` trains on
    (batch 4, the six cars of each scan): an f32 step through kernel B1 and
    through its plain version from the same weights (box_cls_labels and
    regression targets identical, loss terms within 1e-5 relative,
    gradients within 1e-4 max|g| + 1e-7); 2 + 5 bf16 steps, B1 launched in
    every one (one (211200, 50) IoU a scan), every loss term finite,
    positive anchors in every scan, their times and peak memory; one more
    step's B1 calls held to the plain version and timed beside their bound
    (`second_atss_*` keys); one counted step with MATCH_HEIGHT (B1 through
    boxes_iou3d's overlap entry point). Returns the record."""
    from fv2p_torch.datasets import dataset_meta_from_cfg
    from fv2p_torch.ops import cuda as kcuda
    label = 'second_atss'
    zcfg = load_cfg(SECOND_CFG)
    zcfg.MODEL.DENSE_HEAD.TARGET_ASSIGNER_CONFIG.update(ATSS_ASSIGNER)
    tmeta = dataset_meta_from_cfg(zcfg.DATA_CONFIG, 'train')
    rec = {'assigner': dict(ATSS_ASSIGNER), 'batch': int(tbatch['voxels'].shape[0]),
           'gt_boxes': int((tbatch['gt_boxes'][..., 7] > 0).sum())}
    with full_f32():
        step = make_train_step(zcfg, tmeta, None)
        rec['anchors'] = int(step.model.dense_head.anchors_flat.shape[0])
        tk, gk, ok = _zoo_f32_step(step, tbatch, None)
        tp, gp, op = _zoo_f32_step(step, tbatch, kernels)
    rk, rp = ok['anchor_head_ret'], op['anchor_head_ret']
    for key in ('box_cls_labels', 'box_reg_targets', 'reg_weights'):
        if not torch.equal(rk[key], rp[key]):
            fail(f'{label} f32 step: {key} differs between kernel and plain version')
    rec['f32_targets'] = atss_targets(ok)
    rec['f32_kernel_vs_plain'] = compare_train_steps(f'{label} f32 step', tk, tp, gk, gp)
    log(f'# {label} f32 step ({rec["anchors"]} anchors x {tbatch["gt_boxes"].shape[1]} gt rows '
        f'a scan), kernel vs plain version: targets identical ({rec["f32_targets"]}); loss '
        f'terms max relative difference '
        f'{max(rec["f32_kernel_vs_plain"]["loss_rel_diff"].values()):.3g}; worst gradient '
        f'{rec["f32_kernel_vs_plain"]["grad_worst_rel_to_max"]:.3g} of its max')
    del step, ok, op, gk, gp
    torch.cuda.empty_cache()

    step = make_train_step(zcfg, tmeta, torch.bfloat16)
    trec = rec['train'] = timed_train_steps(kcuda, step, tbatch, ('rotated_iou',),
                                            atss_targets)
    if min(trec['first_step_targets']['positive_anchors_per_scan']) <= 0:
        fail(f'{label}: a scan without positive anchors: {trec["first_step_targets"]}')
    log(f'# {label} bf16 step at batch {rec["batch"]}, ms median (quartiles) of '
        f'{TRAIN_TIMED}: ' + ', '.join(
            f'{k} {v["median"]:.2f} ({v["q1"]:.2f}-{v["q3"]:.2f})' for k, v in trec['ms'].items())
        + f'; peak {trec["peak_mem_gib"]:.2f} GiB; launches {trec["launches_per_step"][0]}; '
        f'loss {[round(x, 3) for x in trec["loss_terms"]["loss"]]}; first step '
        f'{trec["first_step_targets"]}')
    tcalls, rec['launches'] = captured_train_calls(kernels, step, tbatch, ('rotated_iou',))
    rec['b1_shapes'] = [[list(a.shape) for a in c[1] if torch.is_tensor(a)]
                        for c in tcalls['rotated_iou'].calls]
    train_kernel_rows(tcalls, rec['launches'], rows, prefix=label)
    del step, tcalls
    torch.cuda.empty_cache()

    zcfg.MODEL.DENSE_HEAD.TARGET_ASSIGNER_CONFIG.MATCH_HEIGHT = True
    step = make_train_step(zcfg, tmeta, torch.bfloat16)
    terms, launches, out = counted_train_step(kcuda, step, tbatch, ('rotated_iou',),
                                              keep_out=True)
    rec['match_height'] = {'terms': {k: float(v) for k, v in terms.items()},
                           'launches': launches, 'targets': atss_targets(out)}
    if not all(np.isfinite(v) for v in rec['match_height']['terms'].values()):
        fail(f'{label} MATCH_HEIGHT step: {rec["match_height"]}')
    log(f'# {label} MATCH_HEIGHT bf16 step: launches {launches}; targets '
        f'{rec["match_height"]["targets"]}; loss {rec["match_height"]["terms"]["loss"]:.4f}')
    del step, out
    torch.cuda.empty_cache()
    return rec


def demo_phase(kernels, rows, ckpt):
    """fv2p_torch.tools.demo.main in this process: fv2p.yaml on data/kitti's
    first val scan with the checkpoint `ckpt` (kitti_train's), bf16, the
    sparse tables built on the card at batch 1, counted (B1-B4 must each
    launch); the same forward once more with every call captured, each call
    held to the plain version and timed (`demo_*` keys); the forward's
    median of FORWARD_REPS on the batch already on the card; the forward in
    f32 without TF32 through the kernels and through the plain versions
    (the same detections); then the default invocation (MGAF-3DSSD on the
    synthetic scan, seeded weights, no checkpoint), counted. Returns the
    record."""
    from fv2p_torch.ops import cuda as kcuda
    from fv2p_torch.tools import demo
    from fv2p_torch.utils.synthetic import batch_to_torch
    label = 'demo'
    argv = ['--cfg_file', str(CFG), '--data_path', str(DEMO_SCAN), '--ckpt', str(ckpt)]
    kcuda.reset_launch_counts()
    run = demo.main(argv)
    sync()
    launches = dict(kcuda.launch_counts)
    if min(n for k, n in launches.items() if k != 'dcn') == 0 or launches['dcn']:
        fail(f'{label}: FV2P\'s demo forward launches every kernel but the DCN\'s: {launches}')
    dets = run['detections']
    rec = {'argv': [str(a) for a in argv], 'launches': launches, 'setup_s': run['setup_s'],
           'first_forward_ms': run['forward_ms'], 'detections': int(dets['pred_scores'].shape[0]),
           'points_valid': int(run['batch']['points_valid'].sum()),
           'voxels': int(run['batch']['voxel_valid'].sum())}
    log(f'# {label}: {" ".join(rec["argv"])}: launches {launches}; host set-up '
        f'{rec["setup_s"]:.2f} s, first forward {rec["first_forward_ms"]:.1f} ms; '
        f'{rec["detections"]} detections ({rec["voxels"]} voxels, {rec["points_valid"]} points)')
    model, batch = run['model'], batch_to_torch(run['batch'], 'cuda')
    _, calls, again = counted_forward(kernels, model, batch, label, ALL_KERNELS)
    if again != launches:
        fail(f'{label}: the second forward launched {again}, the first {launches}')
    train_kernel_rows(calls, launches, rows, prefix=label)
    ms = timed_forwards(model, batch, FORWARD_REPS)
    rec['forward_ms'] = {'median': float(np.median(ms)), 'all': ms}
    log(f'# {label} forward at batch 1, ms median of {FORWARD_REPS}: '
        f'{rec["forward_ms"]["median"]:.2f}')
    del model, calls, run
    torch.cuda.empty_cache()

    with full_f32():
        model32 = demo.build_model(load_cfg(CFG), 'cuda', compute_dtype=None, ckpt=ckpt)
        out_k = forward(model32, batch)
        with patched(kernels, plain_route):
            out_p = forward(model32, batch)
        sync()
    for key in ('pred_valid', 'pred_labels'):
        if not torch.equal(out_k[key], out_p[key]):
            fail(f'{label} f32 forward: {key} differs between kernels and plain versions')
    diffs = {key: float((out_k[key] - out_p[key]).abs().max())
             for key in ('pred_boxes', 'pred_scores', 'point_features',
                         'batch_iouscore_preds')}
    if max(diffs.values()) > F32_ATOL:
        fail(f'{label} f32 forward: {diffs} beyond {F32_ATOL}')
    rec['f32_kernel_vs_plain_max_abs'] = diffs
    rec['f32_detections'] = int(out_k['pred_valid'].sum())
    log(f'# {label} f32 forward, kernels vs plain versions: {rec["f32_detections"]} '
        f'detections in both, {diffs}')
    del model32, out_k, out_p
    torch.cuda.empty_cache()

    kcuda.reset_launch_counts()
    default = demo.main([])
    sync()
    rec['default'] = {'launches': dict(kcuda.launch_counts), 'setup_s': default['setup_s'],
                      'forward_ms': default['forward_ms'],
                      'detections': int(default['detections']['pred_scores'].shape[0])}
    if rec['default']['launches']['rotated_iou'] == 0:
        fail(f'{label}: the default invocation did not reach its NMS: {rec["default"]}')
    log(f'# {label} default invocation (MGAF-3DSSD, synthetic scan): {rec["default"]}')
    del default
    torch.cuda.empty_cache()
    return rec


def kitti_eval_device_phase(kernels, rows, cfg, model, host_rec, host_first, host_first_np):
    """eval_one_epoch over data/kitti's val scans with --rulebooks device,
    the same bf16 model as the host-mode kitti_eval. The first run is
    ``counted_eval``'s (the `kitti_eval_device_*` keys: B3's batch-mixed
    calls at the test cap against the plain version, B1's calls); the
    second's AP dict must equal host mode's; one batch in f32 through host
    and device tables must give the same detections (names identical,
    floats within KITTI_F32_ATOL)."""
    from fv2p_torch.datasets import batch_to_numpy, build_dataloader, dataset_meta_from_cfg
    from fv2p_torch.tools import eval_utils
    from fv2p_torch.tools import test as test_runner
    from fv2p_torch.utils.synthetic import batch_to_torch
    logger = quiet_logger()
    test_set = test_runner.make_dataset(cfg, training=False, logger=logger, rulebooks='device')
    loader = build_dataloader(test_set, KITTI_BATCH, KITTI_WORKERS, training=False,
                              pin_memory=True)
    out_dir = REPO / 'output' / 'chip_smoke' / 'kitti_eval_device'
    out_dir.mkdir(parents=True, exist_ok=True)
    first_np = None
    for b in loader:
        first_np = batch_to_numpy(b)
        break
    if 'rulebooks' in first_np:
        fail('kitti_eval_device: the loader shipped rulebooks')
    ret_a, launches, b1_calls = counted_eval(
        kernels, rows, cfg, model, loader, test_set, out_dir, 'kitti_eval_device',
        ('rotated_iou', 'fps', 'three_nn', 'sa_group', 'sparse_conv'), len(loader),
        library=library_three_nn_chunked)
    ret, _ = eval_utils.eval_one_epoch(cfg, model, loader, test_set, out_dir, logger,
                                       KITTI_BATCH)
    for r in (ret_a, ret):
        if any(not np.isfinite(v) for v in r.values()) or r['device_rulebook_dropped']:
            fail(f'kitti_eval_device: a result is not finite or rows were dropped: {r}')
    ap = {k: v for k, v in ret.items() if '/' in k and not k.startswith('recall/')}
    rec = {k: ret[k] for k in ('sec_per_example', 'loader_wait_s_per_batch',
                               'forward_ms_median', 'device_rulebook_dropped')}
    rec['launches'], rec['b1_calls'] = launches, b1_calls
    rec['ap'], rec['recall'] = ap, {k: v for k, v in ret.items() if k.startswith('recall/')}
    if ap != host_rec['ap']:
        diff = {k: (v, host_rec['ap'].get(k)) for k, v in ap.items() if host_rec['ap'].get(k) != v}
        fail(f'kitti_eval_device: the AP dict differs from host mode\'s: {diff}')
    log(f'# kitti_eval_device: {ret["sec_per_example"] * 1e3:.2f} ms a scan (host tables '
        f'{host_rec["sec_per_example"] * 1e3:.2f}), forward median '
        f'{ret["forward_ms_median"]:.2f} ms (host {host_rec["forward_ms_median"]:.2f}), '
        f'loader wait {ret["loader_wait_s_per_batch"] * 1e3:.2f} ms a batch (host '
        f'{host_rec["loader_wait_s_per_batch"] * 1e3:.2f}); AP dict equal to host mode\'s '
        f'({len(ap)} keys); nothing dropped')
    dev_first = batch_to_torch(eval_utils.pad_batch_to_size(first_np, KITTI_BATCH)[0], 'cuda')
    meta = dataset_meta_from_cfg(cfg.DATA_CONFIG, 'test')
    with full_f32():
        model32 = make_model(cfg, meta, None)
        runs = []
        for bt in (host_first, dev_first):
            out = forward(model32, bt)
            pred = {k: out[k].float().cpu().numpy() if out[k].is_floating_point()
                    else out[k].cpu().numpy() for k in eval_utils.PRED_KEYS}
            runs.append(test_set.generate_prediction_dicts(host_first_np, pred, cfg.CLASS_NAMES))
    worst = 0.0
    for ah, ad in zip(*runs):
        if list(ah['name']) != list(ad['name']):
            fail('kitti_eval_device f32: the detections differ between host and device tables')
        for key in ('bbox', 'dimensions', 'location', 'rotation_y', 'score', 'boxes_lidar'):
            if ah[key].size:
                worst = max(worst, float(np.abs(ah[key] - ad[key]).max()))
    if worst > KITTI_F32_ATOL:
        fail(f'kitti_eval_device f32: host and device tables part by {worst} > {KITTI_F32_ATOL}')
    rec['f32_detections'] = sum(len(a['name']) for a in runs[0])
    rec['f32_max_abs_diff'] = worst
    log(f'# kitti_eval_device f32 batch: {rec["f32_detections"]} detections, host and device '
        f'tables identical in names, max abs difference {worst}')
    del model32, loader
    torch.cuda.empty_cache()
    return rec


def counted_test_run(kernels, rows, label, argv, launched):
    """``fv2p_torch.tools.test.main(argv)`` with the counts set to 0 just
    before and read just after, every kernel call captured: each kernel in
    `launched` must launch, no other; the calls are held against the plain
    versions and timed (the `label`_* keys of `rows`). Returns (the result
    dict, the launches, the kernels with their calls)."""
    from fv2p_torch.ops import cuda as kcuda
    from fv2p_torch.tools import test as test_runner
    cap = copy_kernels(kernels)
    kcuda.reset_launch_counts()
    with patched(cap, capturing):
        ret = test_runner.main(argv)
    sync()
    launches = dict(kcuda.launch_counts)
    for k in cap:
        if (k.name in launched) != (launches[k.name] > 0):
            fail(f'{label} test: kernel {k.name} launched {launches[k.name]} times; the '
                 f'path launches {sorted(launched)}')
        if launches[k.name] != len(k.calls):
            fail(f'{label} {k.name}: {launches[k.name]} launches, {len(k.calls)} calls')
    train_kernel_rows({k.name: k for k in cap}, launches, rows, prefix=label)
    return ret, launches, cap


def kitti_second_phase(kernels, rows):
    """fv2p_torch.tools.train for one epoch of second.yaml on data/kitti's
    32 train scans (Car and Pedestrian: the fixture has no Cyclist; the
    yaml's batch 4, bf16, loading in the main process; fv2p.yaml's train level
    capacities, below), then fv2p_torch.tools.test on its checkpoint over
    the 24 val scans. Both must finish with finite numbers and no rows
    dropped. Each run is counted: training launches no kernel, the test
    run B1 alone, whose calls (NMS, the recall counter, the evaluator) are
    held against the plain version and timed (the `kitti_second_*` keys)."""
    import shutil
    import yaml
    from fv2p_torch.ops import cuda as kcuda
    from fv2p_torch.tools import train as train_runner
    out = REPO / 'output' / 'chip_smoke' / 'kitti_second'
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    full = load_cfg(SECOND_CFG)
    cfg_d = {'CLASS_NAMES': ['Car', 'Pedestrian'], 'DATA_CONFIG': plain_dict(full.DATA_CONFIG),
             'MODEL': plain_dict(full.MODEL), 'OPTIMIZATION': plain_dict(full.OPTIMIZATION)}
    cfg_d['DATA_CONFIG']['DATA_PATH'] = str(KITTI)
    cfg_d['MODEL']['DENSE_HEAD']['ANCHOR_GENERATOR_CONFIG'] = \
        cfg_d['MODEL']['DENSE_HEAD']['ANCHOR_GENERATOR_CONFIG'][:2]
    # second.yaml sets no LEVEL_CAPACITIES, and with gt sampling the derived
    # ones drop rows (1762 in one epoch on the card: JAX drops them without
    # a word, ROADMAP.md C5; the port raises): fv2p.yaml's train caps, set
    # for the same trunk topology on the same scans
    cfg_d['MODEL']['BACKBONE_3D']['LEVEL_CAPACITIES'] = kitti_train_caps()
    cfg_file = out / 'second_car_pedestrian.yaml'
    cfg_file.write_text(yaml.safe_dump(cfg_d))
    common = ['--cfg_file', str(cfg_file), '--workers', str(SHORT_RUN_WORKERS),
              '--output_dir', str(out)]
    t0 = time.perf_counter()
    kcuda.reset_launch_counts()
    run = train_runner.main(common + ['--epochs', '1'])
    sync()
    train_s = time.perf_counter() - t0
    train_launches = dict(kcuda.launch_counts)
    if any(train_launches.values()):
        fail(f'kitti_second: training launched {train_launches}; its path launches none')
    steps = run['steps']
    bad = [(s['it'], k) for s in steps for k, v in s.items() if not np.isfinite(v)]
    if bad or not steps:
        fail(f'kitti_second: {len(steps)} steps, non-finite terms {bad}')
    if any(s['rulebook_dropped'] for s in steps):
        fail('kitti_second: device rulebooks dropped rows')
    step_ms = np.array(run['step_s'][1:]) * 1e3
    wait_ms = np.array(run['loader_wait_s'][1:]) * 1e3
    ckpt = out / 'ckpt' / 'checkpoint_epoch_1.pth'
    ret, test_launches, _ = counted_test_run(kernels, rows, 'kitti_second',
                                             common + ['--ckpt', str(ckpt)], ('rotated_iou',))
    if any(not np.isfinite(v) for v in ret.values()):
        fail(f'kitti_second: a test result is not finite: {ret}')
    rec = {'steps': len(steps), 'train_wall_s': train_s, 'train_launches': train_launches,
           'test_launches': test_launches,
           'step_ms_median': float(np.median(step_ms)) if step_ms.size else None,
           'loader_wait_ms_mean': float(wait_ms.mean()) if wait_ms.size else None,
           'loss': [s['loss'] for s in steps],
           'test': {k: ret[k] for k in ('sec_per_example', 'loader_wait_s_per_batch',
                                        'forward_ms_median', 'device_rulebook_dropped')},
           'test_ap': {k: v for k, v in ret.items() if k.startswith('Car_3d/')}}
    log(f'# kitti_second: {len(steps)} train steps at batch '
        f'{cfg_d["OPTIMIZATION"]["BATCH_SIZE_PER_GPU"]} through the runner, step median '
        f'{rec["step_ms_median"]} ms (loader wait {rec["loader_wait_ms_mean"]} ms a step), '
        f'loss {[round(x, 3) for x in rec["loss"]]}; test: '
        f'{ret["sec_per_example"] * 1e3:.2f} ms a scan, loader wait '
        f'{ret["loader_wait_s_per_batch"] * 1e3:.2f} ms a batch, Car 3D {rec["test_ap"]}')
    return rec


# ------------------------------------------------------ nuScenes (CBGS)

NUSC = REPO / 'data' / 'nuscenes'
NUSC_CFGS = REPO / 'tools' / 'cfgs' / 'nuscenes_models'
NUSC_SECOND_CFG = NUSC_CFGS / 'cbgs_second_multihead.yaml'
NUSC_PP_CFG = NUSC_CFGS / 'cbgs_pp_multihead.yaml'
NUSC_OVERFIT_CFG = NUSC_CFGS / 'cbgs_second_multihead_overfit.yaml'
# level capacities a scan: the most rows the phase's scans occupy, times
# this margin, rounded up to a multiple of CAP_ROUND
CAP_MARGIN, CAP_ROUND = 1.10, 1024
# the class-logit shift of each CBGS phase's eval model: with BatchNorm
# calibrated on the batch, cbgs_pp_multihead.yaml's seeded heads leave most
# (scan, class) NMS lanes under NMS_POST_MAXSIZE candidates above
# SCORE_THRESH (`candidates_per_lane_unshifted`), so B1 would see lanes of
# a few boxes; +1.0 fills them
NUSC_CLS_SHIFT = {'nuscenes': 0.0, 'nuscenes_pp': 1.0}
# the nuScenes runner's check: capacities that drop rows on the fixture
NUSC_SMALL_CAPS = {'x_conv2': 20000, 'x_conv3': 12000, 'x_conv4': 6000, 'out': 4000}
# the nuScenes runner's training: after one epoch (10 steps) the eval-mode
# BatchNorm statistics are still ~90% their initial ones, the residual
# trunk's activations grow layer by layer in eval, and most decoded boxes
# overflow f32; 20 epochs leave 0.99^200 = 13% of the initial statistics
# (30, 5%, took ~130 s of the script, cut to keep it near 660 s).
# It builds its rulebooks on the card: with host tables (4 workers, the
# yaml's capacities) the loader's wait took most of each step
NUSC_RUNNER_EPOCHS = 20


def check_nuscenes_fixture():
    need = [NUSC / 'v1.0-trainval' / n for n in (
        'nuscenes_infos_10sweeps_train.pkl', 'nuscenes_infos_10sweeps_val.pkl',
        'nuscenes_dbinfos_10sweeps_withvelo.pkl', 'gt_database_10sweeps_withvelo', 'samples')]
    missing = [str(p.relative_to(REPO)) for p in need if not p.exists()]
    if missing:
        fail(f'the nuScenes fixture is missing {missing}: data/nuscenes must go with the copy')


def nuscenes_dataset(zcfg, training, seed):
    """NuScenesDataset of data/nuscenes for one mode, its draws seeded: in
    training the CBGS-resampled train split (gt sampling and all), in test
    mode the 2 val scans followed by the 4 train scans."""
    import pickle
    from fv2p_torch.datasets import build_dataset
    ds = build_dataset(zcfg.DATA_CONFIG, zcfg.CLASS_NAMES, training=training,
                       logger=quiet_logger(), rng=np.random.RandomState(seed))
    if not training:
        with open(ds.root_path / zcfg.DATA_CONFIG.INFO_PATH['train'][0], 'rb') as f:
            ds.infos = ds.infos + pickle.load(f)
    return ds


def nuscenes_batch(zcfg, training, seed):
    """The first BATCH samples of ``nuscenes_dataset`` on the card. With a
    sparse trunk, host rulebooks at measured capacities: the samples are
    built once at capacities no scan reaches and the rows each level holds
    read, then built again from the same draws at the most rows a level
    holds times CAP_MARGIN. Returns (batch, record)."""
    from fv2p_torch.ops.sparse import host_rulebook
    from fv2p_torch.utils.synthetic import batch_to_torch
    ds = nuscenes_dataset(zcfg, training, seed)
    rec = {'scans': [info['token'] for info in ds.infos[:BATCH]]}
    backbone = zcfg.MODEL.get('BACKBONE_3D')
    if backbone is not None:
        state = ds.rng.get_state()
        roomy = 8 * ds.data_processor.max_voxels
        ds.set_rulebook_spec(backbone.NAME, caps_override={
            lvl: roomy for lvl in ('x_conv2', 'x_conv3', 'x_conv4', 'out')})
        host_rulebook.reset_overflow_stats()
        for i in range(BATCH):
            ds[i]
        occupancy = host_rulebook.get_overflow_stats()['max_active']
        caps = {lvl: -(-int(CAP_MARGIN * n) // CAP_ROUND) * CAP_ROUND
                for lvl, n in occupancy.items() if lvl != 'x_conv1'}
        ds.rng.set_state(state)
        ds.set_rulebook_spec(backbone.NAME, caps_override=caps)
        rec.update(level_occupancy=occupancy, level_caps=caps)
    ds.gt_rows_dropped = 0
    batch_np = ds.collate_batch([ds[i] for i in range(BATCH)])
    rec['gt_rows_dropped'] = ds.gt_rows_dropped
    rec['gt_boxes'] = int((batch_np['gt_boxes'][..., -1] > 0).sum()) if training else None
    return batch_to_torch(batch_np, 'cuda'), rec


def nuscenes_phase(kernels, rows, label, path, later):
    """A CBGS yaml at full width on the nuScenes fixture (``zoo_phase``):
    the eval batch is 4 scans through NuScenesDataset in test mode, the
    train batch the first 4 samples of the CBGS-resampled train split with
    gt sampling; each level's occupancy beside its capacity, the gt rows
    past MAX_GT_BOXES. Most (scan, class) NMS lanes must hold more
    candidates than NMS_POST_MAXSIZE (NUSC_CLS_SHIFT raises the class logits
    where the seeded heads leave them short)."""
    zcfg = load_cfg(path)
    batch, erec = nuscenes_batch(zcfg, False, SEED)
    tbatch, trec = nuscenes_batch(zcfg, True, SEED + 1)
    for mode, r in (('test', erec), ('train', trec)):
        if 'level_caps' in r:
            log(f'# {label} {mode} batch: rows a level holds at most over its {BATCH} scans '
                f'{r["level_occupancy"]}, capacities a scan {r["level_caps"]} (x{CAP_MARGIN})')
    log(f'# {label} train batch: {trec["gt_boxes"]} gt rows, {trec["gt_rows_dropped"]} rows '
        f'past MAX_GT_BOXES dropped by the dataset, as JAX drops them')
    rec = zoo_phase(kernels, rows, label, zcfg, batch, tbatch, later, NUSC_CLS_SHIFT[label])
    rec.update(eval_batch=erec, train_batch_data=trec, cls_shift=NUSC_CLS_SHIFT[label])
    post = int(zcfg.MODEL.POST_PROCESSING.NMS_CONFIG.NMS_POST_MAXSIZE)
    full = sum(n > post for lane in rec['candidates_per_lane'] for n in lane)
    if 2 * full <= BATCH * len(zcfg.CLASS_NAMES):
        fail(f'{label}: {full} of {BATCH * len(zcfg.CLASS_NAMES)} NMS lanes have more than '
             f'{post} candidates above SCORE_THRESH; raise NUSC_CLS_SHIFT')
    del batch, tbatch
    torch.cuda.empty_cache()
    return rec


def nuscenes_runner_phase(kernels, rows, later):
    """The runners on data/nuscenes: fv2p_torch.tools.train for
    NUSC_RUNNER_EPOCHS epochs of cbgs_second_multihead_overfit.yaml (the
    CBGS-resampled train split at batch 4, the yaml's LEVEL_CAPACITIES with
    --rulebooks device, 4 spawned workers), counted (no kernel launches);
    fv2p_torch.tools.test on its checkpoint (loading in the main process)
    with the native evaluator, counted (B1 alone, its calls held to the plain
    version, the `nuscenes_runner_*` keys; B1 appended to `later` as
    ``zoo_phase`` does), mAP and NDS finite; then the
    train epoch again with --rulebooks device and NUSC_SMALL_CAPS, which
    must raise within train.LOG_INTERVAL steps of its first drop and write
    no checkpoint."""
    import shutil
    import yaml
    from fv2p_torch.ops import cuda as kcuda
    from fv2p_torch.tools import train as train_runner
    out = REPO / 'output' / 'chip_smoke' / 'nuscenes_runner'
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    common = ['--cfg_file', str(NUSC_OVERFIT_CFG), '--workers', str(KITTI_WORKERS)]
    t0 = time.perf_counter()
    kcuda.reset_launch_counts()
    run = train_runner.main(common + ['--epochs', str(NUSC_RUNNER_EPOCHS), '--ckpt_save_interval',
                                      str(NUSC_RUNNER_EPOCHS), '--rulebooks', 'device',
                                      '--output_dir', str(out / 'run')])
    sync()
    train_s = time.perf_counter() - t0
    train_launches = dict(kcuda.launch_counts)
    if any(train_launches.values()):
        fail(f'nuscenes_runner: training launched {train_launches}; its path launches none')
    steps = run['steps']
    bad = [(s['it'], k) for s in steps for k, v in s.items() if not np.isfinite(v)]
    if bad or not steps or any(s['rulebook_dropped'] for s in steps):
        fail(f'nuscenes_runner: {len(steps)} steps, non-finite terms {bad}, or rows dropped')
    step_ms = np.array(run['step_s'][1:]) * 1e3
    wait_ms = np.array(run['loader_wait_s'][1:]) * 1e3
    ret, test_launches, cap = counted_test_run(kernels, rows, 'nuscenes_runner', common + [
        '--workers', str(SHORT_RUN_WORKERS),
        '--ckpt', str(out / 'run' / 'ckpt' / f'checkpoint_epoch_{NUSC_RUNNER_EPOCHS}.pth'),
        '--output_dir', str(out / 'run')], ('rotated_iou',))
    later.append(('nuscenes_runner', next(k for k in cap if k.name == 'rotated_iou')))
    del cap
    if not all(np.isfinite(ret[k]) for k in ('mAP', 'NDS')) or \
            any(not np.isfinite(v) for v in ret.values()):
        fail(f'nuscenes_runner: a test result is not finite or missing: {ret}')

    # device rulebooks at capacities that drop rows: the run must stop
    # within LOG_INTERVAL steps of its first drop, before any checkpoint
    # (the yaml's _BASE_CONFIG_ paths are relative to tools/, wherever it is)
    small_d = yaml.safe_load(NUSC_OVERFIT_CFG.read_text())
    small_d['MODEL']['BACKBONE_3D']['LEVEL_CAPACITIES'] = dict(NUSC_SMALL_CAPS)
    small_file = out / 'overfit_small_caps.yaml'
    small_file.write_text(yaml.safe_dump(small_d))
    steps_run = []
    orig_step = train_runner.TrainStep.step

    def counted_step(self, batch):
        out_ = orig_step(self, batch)
        steps_run.append(int(out_['rulebook_dropped']))
        return out_
    train_runner.TrainStep.step = counted_step
    try:
        train_runner.main(['--cfg_file', str(small_file), '--workers', str(KITTI_WORKERS),
                           '--epochs', '1', '--rulebooks', 'device',
                           '--output_dir', str(out / 'small')])
        fail('nuscenes_runner: the device-mode run at small capacities did not raise')
    except RuntimeError as e:
        raised = str(e)
    finally:
        train_runner.TrainStep.step = orig_step
    first = next((i + 1 for i, d in enumerate(steps_run) if d), None)
    ckpts = sorted((out / 'small' / 'ckpt').glob('*.pth'))
    if first is None or len(steps_run) - first >= train_runner.LOG_INTERVAL or ckpts \
            or 'LEVEL_CAPACITIES' not in raised:
        fail(f'nuscenes_runner: device overflow: first drop at step {first}, raised after '
             f'{len(steps_run)} steps (bound {train_runner.LOG_INTERVAL}), checkpoints '
             f'{ckpts}: {raised}')
    rec = {'steps': len(steps), 'train_wall_s': train_s, 'train_launches': train_launches,
           'test_launches': test_launches,
           'step_ms_median': float(np.median(step_ms)) if step_ms.size else None,
           'loader_wait_ms_mean': float(wait_ms.mean()) if wait_ms.size else None,
           'loss': [s['loss'] for s in steps],
           'test': {k: ret[k] for k in ('sec_per_example', 'loader_wait_s_per_batch',
                                        'forward_ms_median', 'mAP', 'NDS')},
           'overflow_check': {'first_drop_step': first, 'steps_run': len(steps_run),
                              'message': raised}}
    log(f'# nuscenes_runner: {len(steps)} train steps at batch 4 through the runner '
        f'({train_s:.1f} s), step median {rec["step_ms_median"]} ms (loader wait '
        f'{rec["loader_wait_ms_mean"]} ms a step), loss {rec["loss"][0]:.3f} at the first '
        f'step, {np.mean(rec["loss"][-10:]):.3f} over the last 10; test: '
        f'{ret["sec_per_example"] * 1e3:.2f} ms a scan, mAP {ret["mAP"]:.4f}, NDS '
        f'{ret["NDS"]:.4f}; device mode at {NUSC_SMALL_CAPS}: rows dropped from step {first}, '
        f'raised after step {len(steps_run)}, no checkpoint: {raised}')
    return rec


# ------------------------------------------- RoI-grid models (PV-RCNN, Voxel R-CNN)

PV_RCNN_CFG = REPO / 'tools' / 'cfgs' / 'kitti_models' / 'pv_rcnn.yaml'
PV_RCNN_CAR_CFG = REPO / 'tools' / 'cfgs' / 'kitti_models' / 'pv_rcnn_car.yaml'
VOXEL_RCNN_CFG = REPO / 'tools' / 'cfgs' / 'kitti_models' / 'voxel_rcnn' / 'voxel_rcnn_car.yaml'
# each path's yaml and the kernels it launches
GRID_PATHS = {'pv_rcnn': (PV_RCNN_CFG, ('rotated_iou', 'fps')),
              'voxel_rcnn': (VOXEL_RCNN_CFG, ('rotated_iou',))}
# the most temporaries one ball-query call may hold beyond its inputs and
# outputs at the bench batch (pointops.BALL_QUERY_PAIRS bounds them)
BALL_QUERY_GIB = 1.0


def grid_sources(model):
    """The ball-query calls of one forward of a RoI-grid model, in order:
    VSA's raw points and sparse levels, then the RoI grid (PV-RCNN), or
    the grid's sparse levels (Voxel R-CNN); PointRCNN's SA levels."""
    if hasattr(model, 'pfe'):
        return ['raw_points'] + list(model.pfe.levels) + ['roi_grid']
    if hasattr(model.backbone_3d, 'n_sa'):              # PointNet2MSG: one a SA level
        return [f'sa{i}' for i in range(model.backbone_3d.n_sa)]
    return [f'roi_grid_{s}' for s in model.roi_head.sources]


@contextlib.contextmanager
def ball_query_probe(records):
    """Each ``pointops.ball_query_rows`` call timed alone (CUDA events, the
    card synchronised around it), with its peak memory beyond its inputs
    and outputs, and the share of non-empty balls per radius."""
    from fv2p_torch.ops import pointops
    orig = pointops.ball_query_rows

    def probe(new_xyz, xyz, valid, bounds, radii, nsamples, **kw):
        sync()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = orig(new_xyz, xyz, valid, bounds, radii, nsamples, **kw)
        ev[1].record()
        sync()
        out_bytes = sum(o.numel() * o.element_size() for o in out)
        records.append({
            'queries': list(new_xyz.shape[:2]), 'source_rows': int(xyz.shape[0]),
            'radii': list(radii), 'nsamples': list(nsamples), 'ms': ev[0].elapsed_time(ev[1]),
            'temp_gib': (torch.cuda.max_memory_allocated() - base - out_bytes) / 2 ** 30,
            'nonempty_share': [float((o[..., 0] >= 0).float().mean()) for o in out]})
        return out

    pointops.ball_query_rows = probe
    try:
        yield
    finally:
        pointops.ball_query_rows = orig


def ball_query_stats(model, run, label):
    """One run() (a forward or a train step of `model`) under
    ``ball_query_probe``, each call named by its source; every call within
    BALL_QUERY_GIB, and balls fed at every source."""
    records = []
    with ball_query_probe(records):
        run()
    names = grid_sources(model)
    if len(records) != len(names):
        fail(f'{label}: {len(records)} ball-query calls, expected {len(names)} ({names})')
    out = dict(zip(names, records))
    worst = max(r['temp_gib'] for r in records)
    if worst > BALL_QUERY_GIB:
        fail(f'{label}: a ball-query call holds {worst:.3f} GiB of temporaries > '
             f'{BALL_QUERY_GIB}')
    if min(min(r['nonempty_share']) for r in records) <= 0.0:
        fail(f'{label}: a source leaves every ball empty: '
             f'{ {n: r["nonempty_share"] for n, r in out.items()} }')
    log(f'# {label} ball queries (ms each, alone; peak temporaries GiB; non-empty balls per '
        f'radius): ' + '; '.join(
            f'{n} {r["ms"]:.2f} ms, {r["temp_gib"]:.3f} GiB, '
            f'{[round(x, 3) for x in r["nonempty_share"]]} '
            f'({r["queries"][1]} queries a scan, {r["source_rows"]} rows)'
            for n, r in out.items()))
    return out


def pfe_times(model, batch):
    """ms of VSA's parts in one forward (CUDA events, median of
    MODULE_REPS): FPS, each source's grouping and the fusion; `other`
    is the rest of the module (the BEV sampling, the bounds' host read)."""
    from fv2p_torch.ops import pointops
    pfe = model.pfe
    parts = {n: m for n, m in pfe.named_children()}
    passes = []
    for _ in range(MODULE_REPS):
        events = {n: [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                  for n in ['pfe', 'fps'] + list(parts)}
        handles = [pfe.register_forward_pre_hook(lambda m, a: events['pfe'][0].record()),
                   pfe.register_forward_hook(lambda m, a, o: events['pfe'][1].record())]
        for n, m in parts.items():
            handles.append(m.register_forward_pre_hook(
                lambda m_, a, e=events[n]: e[0].record()))
            handles.append(m.register_forward_hook(
                lambda m_, a, o, e=events[n]: e[1].record()))
        fps_fn = pointops.farthest_point_sample_batch

        def timed_fps(*a):
            events['fps'][0].record()
            out = fps_fn(*a)
            events['fps'][1].record()
            return out
        pointops.farthest_point_sample_batch = timed_fps
        try:
            sync()
            forward(model, batch)
            sync()
        finally:
            pointops.farthest_point_sample_batch = fps_fn
            for h in handles:
                h.remove()
        ms = {n: e[0].elapsed_time(e[1]) for n, e in events.items()}
        ms['fusion'] = ms.pop('fusion_fc') + ms.pop('fusion_bn')
        ms['other'] = ms['pfe'] - sum(v for k, v in ms.items() if k != 'pfe')
        passes.append(ms)
    return {k: float(np.median([p[k] for p in passes])) for k in passes[0]}


def grid_nms_keeps(kernels, model, label, head_io, out):
    """The proposal NMS (the RoI head's TEST config on the dense head's
    predictions) and the final cls-score NMS through B1 and through its
    plain version: the keep lists must be identical."""
    from fv2p_torch.models.roi_heads.iouguided_roi_head import proposal_layer
    nms_cfg = model.model_cfg.ROI_HEAD.NMS_CONFIG.TEST
    final_in = {k: out[k] for k in ('batch_box_preds', 'batch_cls_preds',
                                    'cls_preds_normalized')}
    ker = (proposal_layer(head_io['box'], head_io['cls'], nms_cfg),
           model.post_processing(dict(final_in)))
    with patched(kernels, plain_route):
        pln = (proposal_layer(head_io['box'], head_io['cls'], nms_cfg),
               model.post_processing(dict(final_in)))
    if not all(torch.equal(a, b) for a, b in zip(ker[0], pln[0])):
        fail(f'{label}: proposal NMS keeps differ between kernel and plain overlaps')
    for key in ('pred_boxes', 'pred_valid', 'pred_labels'):
        if not torch.equal(ker[1][key], pln[1][key]):
            fail(f'{label}: final NMS {key} differs between kernel and plain overlaps')
    n_props = int(ker[0][3].sum())
    log(f'# {label}: NMS keep lists identical (proposal NMS {n_props} RoIs over '
        f'{head_io["box"].shape[0]} scans, final NMS {int(ker[1]["pred_valid"].sum())} '
        f'detections)')
    return n_props


def grid_train_targets(out):
    """Foreground counts of one RoI-grid train forward, and the rows the
    device rulebooks dropped (must be none)."""
    rec = {'positive_anchors': int((out['anchor_head_ret']['box_cls_labels'] > 0).sum()),
           'foreground_rois': int(out['roi_head_ret']['reg_valid_mask'].sum()),
           'sampled_rois': int(out['roi_head_ret']['reg_valid_mask'].numel()),
           'rulebook_dropped': int(out['rulebook_overflow'].sum())}
    if 'point_head_ret' in out:
        rec['foreground_keypoints'] = int(
            (out['point_head_ret']['point_cls_labels'] > 0).sum())
    return rec


def _grid_f32_step(step, batch, kernels):
    """Loss terms, gradients, FPS picks, proposal keeps and sampled RoIs of
    one f32 train step, through the plain versions when `kernels` is given;
    the weights and statistics are left as they were."""
    from fv2p_torch.models.roi_heads import pvrcnn_head
    from fv2p_torch.ops import pointops
    picks, props = [], []
    fps_fn, prop_fn = pointops.fps, pvrcnn_head.proposal_layer

    def fps_rec(*a):
        picks.append(fps_fn(*a))
        return picks[-1]

    def prop_rec(*a):
        props.append(prop_fn(*a))
        return props[-1]
    pointops.fps, pvrcnn_head.proposal_layer = fps_rec, prop_rec
    try:
        terms, grads, out = _zoo_f32_step(step, batch, kernels)
    finally:
        pointops.fps, pvrcnn_head.proposal_layer = fps_fn, prop_fn
    return terms, grads, picks, props, out['roi_head_ret']['rois_sampled'].detach()


def grid_phase(kernels, rows, label, batch, tbatch, later):
    """A RoI-grid yaml (GRID_PATHS) at full width in bf16 on the bench batch
    (batch 4, the voxels and each scan's 18000 raw points; the backbone
    builds its rulebooks), BatchNorm calibrated on the batch. Counted (each
    kernel of the path launches, no other; B2 once, B1 at least twice a
    scan), every kernel call held against its plain version and timed
    (`label`_* keys of `rows`; the calls appended to `later` for their device
    time), proposal and final NMS keeps identical on both routes, the f32
    forward through the kernels against the plain versions; the forward's
    median, per module (VSA by part), peak memory, host waits, and each
    ball-query call alone. Then train steps at the yaml's batch 4 on
    24000-point scans with the six cars of each scan: an f32 step through
    the kernels and through the plain versions (FPS picks, proposal keeps and
    sampled RoIs identical, loss terms and gradients as FV2P's), 2 + 5 bf16
    steps (each counted, every loss term finite, no rows dropped), one more
    with each ball-query call alone, and one more whose kernel calls are
    held to the plain versions and timed (`label`_train_* keys). Returns
    the record."""
    from fv2p_torch.datasets import dataset_meta_from_cfg
    from fv2p_torch.ops import cuda as kcuda
    path, launched = GRID_PATHS[label]
    zcfg = load_cfg(path)
    meta = dataset_meta_from_cfg(zcfg.DATA_CONFIG, 'test')
    rec = {'voxels_per_scan': batch['voxel_valid'].sum(1).tolist(),
           'points_per_scan': batch['points_valid'].sum(1).tolist()}
    model = make_model(zcfg, meta, torch.bfloat16, calibrate_on=batch)
    rec['parameters'] = sum(p.numel() for p in model.parameters())
    post, _ = nms_lanes(zcfg)
    head_io = {}
    hook = model.dense_head.register_forward_hook(lambda m, a, o: head_io.update(
        box=o['batch_box_preds'].clone(), cls=o['batch_cls_preds'].clone()))
    out, calls, launches = counted_forward(kernels, model, batch, label, launched)
    hook.remove()
    keys = ('batch_box_preds', 'batch_cls_preds') + (
        ('point_features',) if 'fps' in launched else ())
    rec['valid_detections'] = check_outputs(out, post, keys)
    rec['launches'] = launches
    if launches['rotated_iou'] < 2 * BATCH:
        fail(f'{label}: B1 launched {launches["rotated_iou"]} times, expected at least '
             f'{2 * BATCH}')
    if 'fps' in launched and launches['fps'] != 1:
        fail(f'{label}: B2 launched {launches["fps"]} times a forward, expected 1')
    if int(out['rulebook_overflow'].sum()):
        fail(f'{label}: the device rulebooks dropped {out["rulebook_overflow"].tolist()} rows')
    log(f'# {label}: {rec["parameters"]} parameters, {rec["valid_detections"]} valid '
        f'detections over {BATCH} scans')
    rec['proposals'] = grid_nms_keeps(kernels, model, label, head_io, out)
    del out, head_io
    train_kernel_rows(calls, launches, rows, prefix=label)
    later.extend((label, calls[name]) for name in launched)
    rec['f32_kernel_vs_plain_max_abs'] = f32_forward(
        kernels, zcfg, meta, batch, post, keys, label,
        ('pred_boxes', 'pred_scores', 'batch_box_preds', 'batch_cls_preds'), calibrate=True)
    rec.update(forward_stats(model, batch, label))
    if hasattr(model, 'pfe'):
        rec['pfe_ms'] = pfe_times(model, batch)
        log(f'# {label} VSA by part (ms, median of {MODULE_REPS}): '
            f'{ {k: round(v, 3) for k, v in rec["pfe_ms"].items()} }')
    rec['ball_queries'] = ball_query_stats(model, lambda: forward(model, batch), label)
    rec['host_syncs'], rec['host_sync_sites'] = host_syncs(lambda: forward(model, batch))
    log(f'# {label} host waits in one forward: {rec["host_syncs"]}; by line: '
        f'{rec["host_sync_sites"]}')
    del model
    torch.cuda.empty_cache()

    tmeta = dataset_meta_from_cfg(zcfg.DATA_CONFIG, 'train')
    rec['train_batch'] = int(zcfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)
    if rec['train_batch'] != tbatch['voxels'].shape[0]:
        fail(f'{label}: the train batch holds {tbatch["voxels"].shape[0]} scans, the yaml '
             f'{rec["train_batch"]}')
    rec['train_points_per_scan'] = tbatch['points_valid'].sum(1).tolist()
    with full_f32():
        step = make_train_step(zcfg, tmeta, None)
        tk, gk, pk, nk, rk = _grid_f32_step(step, tbatch, None)
        tp, gp, pp, np_, rp = _grid_f32_step(step, tbatch, kernels)
    if len(pk) != (1 if 'fps' in launched else 0) or not all(
            torch.equal(a, b) for a, b in zip(pk, pp)):
        fail(f'{label} f32 step: FPS picks differ between kernel and plain')
    if len(nk) != 1 or not all(torch.equal(a, b) for a, b in zip(nk[0], np_[0])):
        fail(f'{label} f32 step: proposal NMS keeps differ between kernel and plain')
    if not torch.equal(rk, rp):
        fail(f'{label} f32 step: sampled RoIs differ between kernel and plain')
    rec['f32_kernel_vs_plain'] = compare_train_steps(f'{label} f32 step', tk, tp, gk, gp)
    log(f'# {label} f32 train step, kernels vs plain versions: FPS picks, proposal keeps '
        f'and sampled RoIs identical; loss terms max relative difference '
        f'{max(rec["f32_kernel_vs_plain"]["loss_rel_diff"].values()):.3g}; worst gradient '
        f'{rec["f32_kernel_vs_plain"]["grad_worst_rel_to_max"]:.3g} of its max')
    del step
    torch.cuda.empty_cache()
    step = make_train_step(zcfg, tmeta, torch.bfloat16)
    trec = rec['train'] = timed_train_steps(kcuda, step, tbatch, launched, grid_train_targets)
    first = trec['first_step_targets']
    if first['rulebook_dropped'] or first['positive_anchors'] <= 0 or \
            first['foreground_rois'] <= 0 or first.get('foreground_keypoints', 1) <= 0:
        fail(f'{label} train: first step targets {first}')
    if 'fps' in launched and any(n['fps'] != 1 for n in trec['launches_per_step']):
        fail(f'{label} train: B2 launches per step {[n["fps"] for n in trec["launches_per_step"]]}')
    log(f'# {label} train bf16 step at batch {rec["train_batch"]}, ms median (quartiles) of '
        f'{TRAIN_TIMED}: ' + ', '.join(
            f'{k} {v["median"]:.2f} ({v["q1"]:.2f}-{v["q3"]:.2f})' for k, v in trec['ms'].items())
        + f'; peak {trec["peak_mem_gib"]:.2f} GiB; loss '
        f'{[round(x, 3) for x in trec["loss_terms"]["loss"]]}; first step {first}')
    rec['train_ball_queries'] = ball_query_stats(step.model, lambda: step.step(tbatch),
                                                 f'{label} train')
    tcalls, rec['train_launches'] = captured_train_calls(kernels, step, tbatch, launched)
    train_kernel_rows(tcalls, rec['train_launches'], rows, prefix=f'{label}_train')
    del step, tcalls
    torch.cuda.empty_cache()
    return rec


def grid_batches(meta, batch_np):
    """(eval batch, train batch) on the card for the RoI-grid models: the
    bench batch's voxels and raw points without tables, and a train batch of
    the same kind at the yaml's batch 4 with each scan padded to
    TRAIN_POINTS points (B2's 24576-point instantiation) and its six cars as
    gt."""
    from fv2p_torch.utils.synthetic import batch_to_torch, synthetic_batch_np
    keep = ('voxels', 'voxel_coords', 'voxel_num_points', 'voxel_valid', 'points',
            'points_valid')
    train_np = synthetic_batch_np(meta, BATCH, N_CAP, N_FILL, TRAIN_POINTS, seed=SEED + 3,
                                  gt='scan', pad_points=True)
    return (batch_to_torch({k: batch_np[k] for k in keep}, 'cuda'),
            batch_to_torch({k: train_np[k] for k in keep + ('gt_boxes',)}, 'cuda'))


def kitti_pv_rcnn_phase(kernels, rows):
    """fv2p_torch.tools.train for one epoch of pv_rcnn_car.yaml on
    data/kitti's 32 train scans (batch 4, 8 steps, bf16, loading in the main process,
    device rulebooks at fv2p.yaml's train level capacities: pv_rcnn_car.yaml
    sets none and its derived ones drop rows under gt sampling; the peak
    learning rate at KITTI_TRAIN_LR, as kitti_train), then
    fv2p_torch.tools.test on its checkpoint over the 24 val scans. Each run
    is counted: both launch B1 and B2 and nothing else; the test run's calls
    are held against the plain versions and timed (`kitti_pv_rcnn_*` keys).
    The AP dict must be produced and every number finite."""
    import shutil
    import yaml
    from fv2p_torch.ops import cuda as kcuda
    from fv2p_torch.tools import train as train_runner
    launched = GRID_PATHS['pv_rcnn'][1]
    out = REPO / 'output' / 'chip_smoke' / 'kitti_pv_rcnn'
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    cfg_d = yaml.safe_load(PV_RCNN_CAR_CFG.read_text())
    cfg_d['DATA_CONFIG']['_BASE_CONFIG_'] = str(
        REPO / 'tools' / cfg_d['DATA_CONFIG']['_BASE_CONFIG_'])
    cfg_d['DATA_CONFIG']['DATA_PATH'] = str(KITTI)
    cfg_d['MODEL']['BACKBONE_3D']['LEVEL_CAPACITIES'] = kitti_train_caps()
    cfg_d['OPTIMIZATION']['LR'] = KITTI_TRAIN_LR
    cfg_file = out / 'pv_rcnn_car_fixture.yaml'
    cfg_file.write_text(yaml.safe_dump(cfg_d))
    common = ['--cfg_file', str(cfg_file), '--workers', str(SHORT_RUN_WORKERS),
              '--output_dir', str(out), '--rulebooks', 'device']
    t0 = time.perf_counter()
    kcuda.reset_launch_counts()
    run = train_runner.main(common + ['--epochs', '1'])
    sync()
    train_s = time.perf_counter() - t0
    train_launches = dict(kcuda.launch_counts)
    for name, n in train_launches.items():
        if (name in launched) != (n > 0):
            fail(f'kitti_pv_rcnn: training launched {train_launches}; the path launches '
                 f'{launched}')
    steps = run['steps']
    bad = [(s['it'], k) for s in steps for k, v in s.items() if not np.isfinite(v)]
    if bad or len(steps) != 8 or any(s['rulebook_dropped'] for s in steps):
        fail(f'kitti_pv_rcnn: {len(steps)} steps (expected 8), non-finite terms {bad}, or '
             f'rows dropped')
    if train_launches['fps'] != len(steps):
        fail(f'kitti_pv_rcnn: B2 launched {train_launches["fps"]} times in {len(steps)} steps')
    step_ms = np.array(run['step_s'][1:]) * 1e3
    wait_ms = np.array(run['loader_wait_s'][1:]) * 1e3
    ret, test_launches, _ = counted_test_run(
        kernels, rows, 'kitti_pv_rcnn',
        common + ['--ckpt', str(out / 'ckpt' / 'checkpoint_epoch_1.pth')], launched)
    ap = {k: v for k, v in ret.items() if k.startswith('Car_')}
    if not ap or any(not np.isfinite(v) for v in ret.values()):
        fail(f'kitti_pv_rcnn: no AP dict or a result not finite: {ret}')
    rec = {'steps': len(steps), 'train_wall_s': train_s, 'train_launches': train_launches,
           'test_launches': test_launches,
           'step_ms': {'median': float(np.median(step_ms)), 'all': step_ms.tolist()},
           'loader_wait_ms_mean': float(wait_ms.mean()),
           'loss': [s['loss'] for s in steps],
           'test': {k: ret[k] for k in ('sec_per_example', 'loader_wait_s_per_batch',
                                        'forward_ms_median', 'device_rulebook_dropped')},
           'test_ap_car_3d': {k: v for k, v in ap.items() if k.startswith('Car_3d/')}}
    log(f'# kitti_pv_rcnn: {len(steps)} train steps at batch '
        f'{cfg_d["OPTIMIZATION"]["BATCH_SIZE_PER_GPU"]} through the runner ({train_s:.1f} s), '
        f'step median {rec["step_ms"]["median"]:.2f} ms (loader wait '
        f'{rec["loader_wait_ms_mean"]:.2f} ms a step), loss '
        f'{[round(x, 3) for x in rec["loss"]]}; test: {ret["sec_per_example"] * 1e3:.2f} ms '
        f'a scan, loader wait {ret["loader_wait_s_per_batch"] * 1e3:.2f} ms a batch, '
        f'forward median {ret["forward_ms_median"]:.2f} ms; {len(ap)} Car AP keys, 3D '
        f'{rec["test_ap_car_3d"]}')
    return rec


# ------------------------------------------------------------ Waymo

WAYMO = REPO / 'data' / 'waymo'
WAYMO_CFGS = REPO / 'tools' / 'cfgs' / 'waymo_models'
WAYMO_FV2P_CFG = WAYMO_CFGS / 'FV2P' / 'waymo_fv2p_e30.yaml'
WAYMO_PV_RCNN_CFG = WAYMO_CFGS / 'pv_rcnn.yaml'
WAYMO_MGAF_GATE_CFG = WAYMO_CFGS / 'MGAF-3DSSD' / 'waymo_mgaf-3dssd_overfit.yaml'
# both Waymo yamls' BATCH_SIZE_PER_GPU
WAYMO_BATCH = 2
# waymo_runner: MGAF epochs on the gate fixture (4 frames at batch 4: a step each)
WAYMO_RUNNER_EPOCHS = 3
ALL_KERNELS = ('rotated_iou', 'fps', 'three_nn', 'sa_group')


def check_waymo_fixture():
    if not (WAYMO / 'ImageSets' / 'val.txt').exists():
        fail(f'{WAYMO} is missing: the Waymo phases run on the committed fixture '
             f'(.chiprunignore must let data/waymo go to the card)')


def waymo_batch(cfg, training, seed=SEED):
    """The first WAYMO_BATCH samples of data/waymo through the port's
    WaymoDataset with `cfg`'s DATA_CONFIG (180000-point scans, the mode's
    voxel cap; train mode with gt sampling and every world augmentation,
    drawn from RandomState(seed)) at SAMPLED_INTERVAL 1: the fixture has 2
    frames a sequence, so the yaml's 5 would leave one frame a split. A
    backbone that reads host rulebooks gets them at the yaml's level
    capacities, which no level may pass. Returns (batch on the card, the
    levels' largest row counts)."""
    import copy
    from fv2p_torch.datasets import build_dataset
    from fv2p_torch.models.backbones_3d import reads_host_tables
    from fv2p_torch.ops.sparse import host_rulebook
    from fv2p_torch.utils.synthetic import batch_to_torch
    dc = copy.deepcopy(cfg.DATA_CONFIG)
    dc.SAMPLED_INTERVAL = {'train': 1, 'test': 1}
    ds = build_dataset(dc, cfg.CLASS_NAMES, root_path=WAYMO, training=training,
                       rng=np.random.RandomState(seed))
    backbone = cfg.MODEL.get('BACKBONE_3D')
    if backbone is not None and reads_host_tables(backbone.NAME):
        ds.set_rulebook_spec(backbone.NAME, caps_override=backbone.get('LEVEL_CAPACITIES'))
    host_rulebook.reset_overflow_stats()
    batch_np = ds.collate_batch([ds[i] for i in range(WAYMO_BATCH)])
    of = host_rulebook.get_overflow_stats()
    if of['samples_over']:
        fail(f'waymo batch: the host rulebooks pass the level capacities: {of}')
    keep = {k: v for k, v in batch_np.items() if k not in ('metadata', 'frame_id')}
    return batch_to_torch(keep, 'cuda'), dict(of['max_active'])


def waymo_fv2p_phase(kernels, rows, later):
    """waymo_fv2p_e30.yaml at full width in bf16 on WAYMO_BATCH val frames
    of data/waymo (the 90000-voxel test cap, 180000-point scans, host
    rulebooks at the yaml's level capacities), seeded weights. Counted (all
    four kernels launch; B2 once, on its 180000-point instantiation), every
    kernel call held against its plain version and timed (`waymo_fv2p_*`
    keys: B2 beside its chain floor; B3's source rows a call), the NMS keeps
    identical on both routes, the f32 forward through the kernels against
    the plain versions; the forward's median, per module and peak memory.
    Then training on WAYMO_BATCH train samples (gt sampling and every
    augmentation, the 80000-voxel train cap): an f32 step through the
    kernels and through the plain versions (FPS picks and proposal keeps
    identical, loss terms and gradients as FV2P's KITTI step), and
    TRAIN_WARMUP + TRAIN_TIMED bf16 steps (B1, B2, B3 on every step, every
    loss term finite). Returns the record."""
    from fv2p_torch.datasets import dataset_meta_from_cfg
    from fv2p_torch.ops import cuda as kcuda
    from fv2p_torch.ops.cuda import fps
    label = 'waymo_fv2p'
    cfg = load_cfg(WAYMO_FV2P_CFG)
    meta = dataset_meta_from_cfg(cfg.DATA_CONFIG, 'test')
    batch, occupancy = waymo_batch(cfg, training=False)
    rec = {'voxels_per_scan': batch['voxel_valid'].sum(1).tolist(),
           'points_per_scan': batch['points_valid'].sum(1).tolist(),
           'points_cap': int(batch['points'].shape[1]), 'level_rows_max': occupancy,
           'level_caps': {k[len('coords_'):]: int(v.shape[1])
                          for k, v in batch['rulebooks'].items() if k.startswith('coords_')}}
    log(f'# {label}: {rec["voxels_per_scan"]} voxels and {rec["points_per_scan"]} of '
        f'{rec["points_cap"]} points a scan; level rows (most) {occupancy}, capacities '
        f'{rec["level_caps"]}')
    model = make_model(cfg, meta, torch.bfloat16)
    rec['parameters'] = sum(p.numel() for p in model.parameters())
    post = int(cfg.MODEL.POST_PROCESSING.NMS_CONFIG.NMS_POST_MAXSIZE)
    head_io = {}
    hook = model.dense_head.register_forward_hook(lambda m, a, o: head_io.update(
        box=o['batch_box_preds'].clone(), cls=o['batch_cls_preds'].clone()))
    out, calls, launches = counted_forward(kernels, model, batch, label, ALL_KERNELS)
    hook.remove()
    decoder = model.post_pfe
    want = {'fps': 1, 'sa_group': 2, 'three_nn': len(
        {decoder.model_cfg.INIT_BLOCK.SOURCE, *decoder.sources})}
    for name, n in want.items():
        if launches[name] != n:
            fail(f'{label}: {name} launched {launches[name]} times, expected {n}')
    if launches['rotated_iou'] < 2 * WAYMO_BATCH:
        fail(f'{label}: B1 launched {launches["rotated_iou"]} times, expected at least '
             f'{2 * WAYMO_BATCH}')
    n_fps = calls['fps'].calls[0][1][0].shape[1]
    if n_fps <= 24 * 1024:
        fail(f'{label}: B2 took {n_fps} points a scan: not its 180000-point instantiation')
    rec['launches'] = launches
    rec['valid_detections'] = check_outputs(out, post, FV2P_KEYS, WAYMO_BATCH)
    rec['three_nn_source_rows'] = [list(c[1][0].shape) for c in calls['three_nn'].calls]
    log(f'# {label}: {rec["parameters"]} parameters, {rec["valid_detections"]} valid '
        f'detections over {WAYMO_BATCH} scans; B3 sources a call {rec["three_nn_source_rows"]}')
    fv2p_nms_keeps(kernels, model, head_io, out, label)
    del out, head_io
    train_kernel_rows(calls, launches, rows, prefix=label)
    later.extend((label, calls[name]) for name in ALL_KERNELS)
    rec['f32_kernel_vs_plain_max_abs'] = f32_forward(
        kernels, cfg, meta, batch, post, FV2P_KEYS, label,
        ('pred_boxes', 'pred_scores', 'point_features', 'batch_iouscore_preds'),
        batch_size=WAYMO_BATCH)
    rec.update(forward_stats(model, batch, label, WAYMO_BATCH))
    del model, batch
    torch.cuda.empty_cache()

    tmeta = dataset_meta_from_cfg(cfg.DATA_CONFIG, 'train')
    tbatch, rec['train_level_rows_max'] = waymo_batch(cfg, training=True)
    rec['train_voxels_per_scan'] = tbatch['voxel_valid'].sum(1).tolist()
    rec['train_gt_boxes'] = int((tbatch['gt_boxes'][..., 7] > 0).sum())
    rec['f32_train_kernel_vs_plain'] = train_f32_compare(kernels, cfg, tmeta, tbatch, label)
    step = make_train_step(cfg, tmeta, torch.bfloat16)
    trec = rec['train'] = timed_train_steps(kcuda, step, tbatch,
                                            ('rotated_iou', 'fps', 'three_nn'), train_targets)
    log(f'# {label} train bf16 step at batch {WAYMO_BATCH} ({rec["train_voxels_per_scan"]} '
        f'voxels, {rec["train_gt_boxes"]} gt boxes), ms median (quartiles) of '
        f'{TRAIN_TIMED}: ' + ', '.join(
            f'{k} {v["median"]:.2f} ({v["q1"]:.2f}-{v["q3"]:.2f})' for k, v in trec['ms'].items())
        + f'; peak {trec["peak_mem_gib"]:.2f} GiB; loss '
        f'{[round(x, 3) for x in trec["loss_terms"]["loss"]]}; first step '
        f'{trec["first_step_targets"]}; level rows (most) {rec["train_level_rows_max"]}')
    del step, tbatch
    torch.cuda.empty_cache()
    return rec


def waymo_pv_rcnn_phase(kernels, rows, later):
    """waymo_models/pv_rcnn.yaml, one bf16 forward at full width on the
    same WAYMO_BATCH val frames (VoxelBackBone8x builds its rulebooks in the
    forward; nothing may be dropped), BatchNorm calibrated on the batch. The
    yaml sets no LEVEL_CAPACITIES and the derived ones drop rows at x_conv3
    and x_conv4 on these frames, so the phase gives it waymo_fv2p_e30.yaml's
    (the same grid and scans), as kitti_pv_rcnn borrows fv2p.yaml's.
    Counted: B2 once (4096 keypoints from 180000-point scans) and B1 at
    least twice a scan, nothing else; every call held to its plain version
    and timed (`waymo_pv_rcnn_*` keys), the NMS keeps identical on both
    routes, each ball-query call alone within BALL_QUERY_GIB (VSA groups
    against the 180000 raw points of each scan)."""
    from fv2p_torch.datasets import dataset_meta_from_cfg
    label, launched = 'waymo_pv_rcnn', ('rotated_iou', 'fps')
    cfg = load_cfg(WAYMO_PV_RCNN_CFG)
    cfg.MODEL.BACKBONE_3D.LEVEL_CAPACITIES = load_cfg(
        WAYMO_FV2P_CFG).MODEL.BACKBONE_3D.LEVEL_CAPACITIES
    meta = dataset_meta_from_cfg(cfg.DATA_CONFIG, 'test')
    batch, _ = waymo_batch(cfg, training=False)
    model = make_model(cfg, meta, torch.bfloat16, calibrate_on=batch)
    rec = {'parameters': sum(p.numel() for p in model.parameters())}
    from fv2p_torch.models.backbones_3d.spconv_backbone import Rulebooks
    with torch.no_grad():
        derived = Rulebooks.on_device(model.vfe(dict(batch)), model.backbone_3d.shapes, None,
                                      False)
    rec['derived_caps_dropped'] = derived.overflow.tolist()
    log(f'# {label}: the derived level capacities would drop {rec["derived_caps_dropped"]} '
        f'rows at x_conv2..out; the phase runs at waymo_fv2p_e30.yaml\'s')
    del derived
    post, _ = nms_lanes(cfg)
    head_io = {}
    hook = model.dense_head.register_forward_hook(lambda m, a, o: head_io.update(
        box=o['batch_box_preds'].clone(), cls=o['batch_cls_preds'].clone()))
    out, calls, launches = counted_forward(kernels, model, batch, label, launched)
    hook.remove()
    rec['launches'] = launches
    if launches['fps'] != 1 or launches['rotated_iou'] < 2 * WAYMO_BATCH:
        fail(f'{label}: launches {launches}, expected B2 once and B1 at least '
             f'{2 * WAYMO_BATCH} times')
    fps_call = calls['fps'].calls[0][1]
    rec['fps_shape'] = list(fps_call[0].shape) + [fps_call[2]]
    if fps_call[0].shape[1] <= 24 * 1024:
        fail(f'{label}: B2 took {fps_call[0].shape[1]} points a scan')
    if int(out['rulebook_overflow'].sum()):
        fail(f'{label}: the device rulebooks dropped {out["rulebook_overflow"].tolist()} rows')
    rec['valid_detections'] = check_outputs(out, post, ('batch_box_preds', 'batch_cls_preds',
                                                        'point_features'), WAYMO_BATCH)
    rec['proposals'] = grid_nms_keeps(kernels, model, label, head_io, out)
    log(f'# {label}: {rec["parameters"]} parameters, B2 {rec["fps_shape"]}, '
        f'{rec["valid_detections"]} valid detections over {WAYMO_BATCH} scans')
    del out, head_io
    train_kernel_rows(calls, launches, rows, prefix=label)
    later.extend((label, calls[name]) for name in launched)
    rec['ball_queries'] = ball_query_stats(model, lambda: forward(model, batch), label)
    del model, batch
    torch.cuda.empty_cache()
    return rec


def waymo_runner_phase(kernels, rows):
    """The runners on Waymo. (1) The gate fixture, written by
    ``python -m fv2p_torch.tools.make_synthetic_waymo`` into output/:
    fv2p_torch.tools.train for WAYMO_RUNNER_EPOCHS epochs of
    waymo_mgaf-3dssd_overfit.yaml (batch 4, one step an epoch, --set
    DATA_CONFIG.DATA_PATH to the tree, --rulebooks device as the Waymo gate
    of tools/torch_learning_gate.sh; nothing dropped), then
    fv2p_torch.tools.test on its
    checkpoint with the yaml's EVAL_METRIC waymo (the native estimator):
    training launches B1 alone, the test run too, its calls held to the
    plain version (`waymo_runner_mgaf_*` keys), and the result carries
    Vehicle L1/L2 AP and APH. (2) data/waymo: one train epoch of
    waymo_fv2p_e30.yaml (SAMPLED_INTERVAL 1: 4 frames, 2 steps at batch 2;
    the peak learning rate at KITTI_TRAIN_LR) and the test runner on its
    checkpoint with EVAL_METRIC kitti (the yaml sets waymo; this run takes
    the KITTI-format branch): training launches B1, B2 and B3, the test run
    all four, held to the plain versions (`waymo_runner_fv2p_*` keys), and
    the result carries the KITTI-format Car AP. Every number finite."""
    import shutil
    from fv2p_torch.ops import cuda as kcuda
    from fv2p_torch.tools import train as train_runner
    out = REPO / 'output' / 'chip_smoke' / 'waymo_runner'
    shutil.rmtree(out, ignore_errors=True)
    gate = out / 'waymo_gate'
    t0 = time.perf_counter()
    subprocess.run([sys.executable, '-m', 'fv2p_torch.tools.make_synthetic_waymo', str(gate)],
                   cwd=REPO, check=True, stdout=subprocess.DEVNULL)
    rec = {'generate_s': time.perf_counter() - t0}
    runs = (('mgaf', WAYMO_MGAF_GATE_CFG, WAYMO_RUNNER_EPOCHS, ['--rulebooks', 'device'],
             ('rotated_iou',), ('rotated_iou',), ['DATA_CONFIG.DATA_PATH', str(gate)]),
            ('fv2p', WAYMO_FV2P_CFG, 1, [], ('rotated_iou', 'fps', 'three_nn'), ALL_KERNELS,
             ['DATA_CONFIG.DATA_PATH', str(WAYMO), 'DATA_CONFIG.SAMPLED_INTERVAL.train', '1',
              'DATA_CONFIG.SAMPLED_INTERVAL.test', '1', 'OPTIMIZATION.LR', str(KITTI_TRAIN_LR),
              'MODEL.POST_PROCESSING.EVAL_METRIC', 'kitti']))
    for name, path, epochs, train_extra, train_launched, test_launched, sets in runs:
        label = f'waymo_runner_{name}'
        common = ['--cfg_file', str(path), '--workers', str(SHORT_RUN_WORKERS),
                  '--output_dir', str(out / name)]
        t0 = time.perf_counter()
        kcuda.reset_launch_counts()
        run = train_runner.main(common + train_extra + [
            '--epochs', str(epochs), '--ckpt_save_interval', str(epochs), '--set', *sets])
        sync()
        train_s = time.perf_counter() - t0
        train_launches = dict(kcuda.launch_counts)
        for k, n in train_launches.items():
            if (k in train_launched) != (n > 0):
                fail(f'{label}: training launched {train_launches}; the path launches '
                     f'{train_launched}')
        steps = run['steps']
        bad = [(s['it'], k) for s in steps for k, v in s.items() if not np.isfinite(v)]
        if bad or not steps or any(s.get('rulebook_dropped', 0) for s in steps):
            fail(f'{label}: {len(steps)} steps, non-finite terms {bad}, or rows dropped')
        t0 = time.perf_counter()
        ret, test_launches, _ = counted_test_run(
            kernels, rows, label,
            common + ['--ckpt', str(out / name / 'ckpt' / f'checkpoint_epoch_{epochs}.pth'),
                      '--set', *sets], test_launched)
        test_s = time.perf_counter() - t0
        if any(not np.isfinite(v) for v in ret.values()):
            fail(f'{label}: a result is not finite: {ret}')
        if name == 'mgaf':
            ap = {k: v for k, v in ret.items() if k.startswith('OBJECT_TYPE_TYPE_VEHICLE')}
            if len(ap) != 4:
                fail(f'{label}: no Vehicle L1/L2 AP and APH in the result: {ret}')
        else:
            ap = {k: v for k, v in ret.items() if k.startswith('Car_3d/')}
            if not ap:
                fail(f'{label}: no KITTI-format Car AP in the result: {ret}')
        rec[name] = {'steps': len(steps), 'train_s': train_s, 'test_s': test_s,
                     'train_launches': train_launches, 'test_launches': test_launches,
                     'loss': [s['loss'] for s in steps],
                     'step_ms_median': float(np.median(run['step_s'][1:] or run['step_s'])
                                             * 1e3),
                     'ap': ap, 'recall': {k: v for k, v in ret.items()
                                          if k.startswith('recall/')},
                     'test': {k: ret[k] for k in ('sec_per_example', 'loader_wait_s_per_batch',
                                                  'forward_ms_median')}}
        log(f'# {label}: {len(steps)} train steps ({train_s:.1f} s; loss '
            f'{[round(x, 3) for x in rec[name]["loss"]]}), test run {test_s:.1f} s '
            f'({ret["sec_per_example"] * 1e3:.2f} ms a scan); launches train '
            f'{train_launches}, test {test_launches}; {ap}')
    return rec


# ------------------------------------------------------ PointRCNN (KITTI)

POINTRCNN_CFG = REPO / 'tools' / 'cfgs' / 'kitti_models' / 'pointrcnn.yaml'
POINTRCNN_IOU_CAR_CFG = REPO / 'tools' / 'cfgs' / 'kitti_models' / 'pointrcnn_iou_car.yaml'
POINTRCNN_LAUNCHED = ('rotated_iou', 'fps', 'three_nn')
# data/kitti holds Car and Pedestrian only (no Cyclist for the gt sampler or
# the evaluator): the PointRCNN train and runner phases cut pointrcnn.yaml's
# classes to those two, as kitti_second does
FIXTURE_CLASSES = ['Car', 'Pedestrian']


def fixture_batch(cfg, training, seed=SEED):
    """The first BATCH samples of data/kitti's val split (or of its train
    split, gt sampling and every augmentation drawn from RandomState(seed))
    through the yaml's KittiDataset, collated, on the card."""
    from fv2p_torch.tools import test as test_runner
    from fv2p_torch.utils.synthetic import batch_to_torch
    ds = test_runner.make_dataset(cfg, training=training, logger=quiet_logger(),
                                  rng=np.random.RandomState(seed))
    return batch_to_torch(ds.collate_batch([ds[i] for i in range(BATCH)]), 'cuda')


def pointrcnn_sites(calls, batch_size):
    """One PointRCNN pass's kernel calls by call site: B2 in the backbone
    (a row a scan) and in the RoI head (a row a RoI: more rows than scans),
    B3 at the backbone's FP levels, B1 in the NMS (and the IoU targets)."""
    def only(name, keep=lambda c: True):
        k = calls[name]
        sub = Kernel(k.name, k.module, k.entries, k.source, k.replaces)
        sub.calls = [c for c in k.calls if keep(c)]
        return sub
    return {'backbone': [only('fps', lambda c: c[1][0].shape[0] == batch_size),
                         only('three_nn')],
            'head': [only('fps', lambda c: c[1][0].shape[0] > batch_size)],
            'nms': [only('rotated_iou')]}


def site_rows(sites, kernels, rows, label):
    """Each call site's calls against the plain versions and timed, under
    `label`_<site>_* keys of the kernel rows."""
    for site, subs in sites.items():
        by_name = {k.name: Kernel(k.name, k.module, k.entries, k.source, k.replaces)
                   for k in kernels}
        by_name.update({k.name: k for k in subs})
        train_kernel_rows(by_name, {n: len(k.calls) for n, k in by_name.items()}, rows,
                          prefix=f'{label}_{site}')


def pointrcnn_train_targets(out):
    """Foreground points and RoIs of one PointRCNN train forward."""
    return {'foreground_points': int((out['point_head_ret']['point_cls_labels'] > 0).sum()),
            'foreground_rois': int(out['roi_head_ret']['reg_valid_mask'].sum()),
            'sampled_rois': int(out['roi_head_ret']['reg_valid_mask'].numel())}


# a PointRCNN train step from seeded weights: each gt box is written over
# the box predictions of GT_PROPOSAL_COPIES points, its center moved by
# N(0, GT_PROPOSAL_JITTER m) on each axis
GT_PROPOSAL_COPIES, GT_PROPOSAL_JITTER = 4, 0.05


def gt_proposals(point_head):
    """Seeded weights propose no box at the RCNN's foreground IoU (0.55), so
    their RoIs train no regression. A forward hook on `point_head` writes
    GT_PROPOSAL_COPIES jittered copies of every gt box of the batch (drawn
    from SEED, the same each step) over the first points' decoded boxes,
    with a logit of 10 in the box's class and -10 in the others: the
    proposal NMS (B1) keeps them, the RoI sampling finds foreground, and the
    RCNN regression and corner terms train. The point head's own
    predictions and losses are untouched. Returns the hook's handle."""
    def hook(module, args, out):
        gt = out['gt_boxes']
        box, cls = out['batch_box_preds'], out['batch_cls_preds']
        rep = gt.repeat_interleave(GT_PROPOSAL_COPIES, dim=1)          # (B, K, 8)
        k = rep.shape[1]
        gen = torch.Generator(device=gt.device).manual_seed(SEED)
        noise = torch.randn(rep[..., :3].shape, generator=gen, device=gt.device)
        boxes = torch.cat([rep[..., :3] + GT_PROPOSAL_JITTER * noise, rep[..., 3:7]], -1)
        labels = (rep[..., 7].long() - 1).clamp(min=0)
        logits = torch.nn.functional.one_hot(labels, cls.shape[-1]) * 20.0 - 10.0
        real = (rep[..., 7] > 0)[..., None]
        out['batch_box_preds'] = torch.cat(
            [torch.where(real, boxes.to(box.dtype), box[:, :k]), box[:, k:]], 1)
        out['batch_cls_preds'] = torch.cat(
            [torch.where(real, logits.to(cls.dtype), cls[:, :k]), cls[:, k:]], 1)
        return out
    return point_head.register_forward_hook(hook)


def kitti_pointrcnn_phase(kernels, rows, later):
    """pointrcnn.yaml at full width on the first BATCH val scans of
    data/kitti (16384 sampled points a scan), seeded weights, BatchNorm
    calibrated on the batch. The model runs in f32 whatever the compute
    dtype, as the JAX package's point modules do (no dtype on their
    layers); it is built for bf16 as the runners build it. Counted: B2 six
    times (the backbone's 4096 of 16384, 1024, 256 and 64 picks, the head's
    128 of 512 and 32 of 128 in each of 400 RoI rows), B3 at the four FP
    levels, B1 at least twice a scan, B4 never; each call site's calls held
    to the plain versions and timed (`kitti_pointrcnn_<site>_*` keys), the
    proposal and final NMS keeps identical on both routes, the f32 forward
    through the kernels against the plain versions; the forward's median,
    per module and peak memory, and each backbone ball query alone (at most
    BALL_QUERY_GIB). Returns the record."""
    from fv2p_torch.datasets import dataset_meta_from_cfg
    label = 'kitti_pointrcnn'
    cfg = load_cfg(POINTRCNN_CFG)
    meta = dataset_meta_from_cfg(cfg.DATA_CONFIG, 'test')
    batch = fixture_batch(cfg, training=False)
    rec = {'points_per_scan': batch['points_valid'].sum(1).tolist(),
           'points_cap': int(batch['points'].shape[1])}
    model = make_model(cfg, meta, torch.bfloat16, calibrate_on=batch)
    rec['parameters'] = sum(p.numel() for p in model.parameters())
    post = int(cfg.MODEL.POST_PROCESSING.NMS_CONFIG.NMS_POST_MAXSIZE)
    head_io = {}
    hook = model.point_head.register_forward_hook(lambda m, a, o: head_io.update(
        box=o['batch_box_preds'].clone(), cls=o['batch_cls_preds'].clone()))
    out, calls, launches = counted_forward(kernels, model, batch, label, POINTRCNN_LAUNCHED)
    hook.remove()
    rec['launches'] = launches
    rec['fps_shapes'] = [list(a[0].shape) + [a[2]] for _, a in calls['fps'].calls]
    rec['three_nn_shapes'] = [[list(a[0].shape), list(a[2].shape)]
                              for _, a in calls['three_nn'].calls]
    if launches['fps'] != 6 or launches['three_nn'] != 4 or \
            launches['rotated_iou'] < 2 * BATCH:
        fail(f'{label}: launches {launches}, expected B2 6, B3 4, B1 at least {2 * BATCH}')
    keys = ('batch_box_preds', 'batch_cls_preds', 'point_features')
    rec['valid_detections'] = check_outputs(out, post, keys)
    rec['proposals'] = grid_nms_keeps(kernels, model, label, head_io, out)
    log(f'# {label}: {rec["parameters"]} parameters, {rec["points_per_scan"]} of '
        f'{rec["points_cap"]} points a scan, {rec["valid_detections"]} valid detections; '
        f'B2 calls {rec["fps_shapes"]}; B3 calls (sources, queries) {rec["three_nn_shapes"]}')
    del out, head_io
    sites = pointrcnn_sites(calls, BATCH)
    site_rows(sites, kernels, rows, label)
    later.extend((f'{label}_{site}', k) for site, subs in sites.items() for k in subs)
    rec['f32_kernel_vs_plain_max_abs'] = f32_forward(
        kernels, cfg, meta, batch, post, keys, label,
        ('pred_boxes', 'pred_scores', 'batch_box_preds', 'batch_cls_preds'), calibrate=True)
    rec.update(forward_stats(model, batch, label))
    fps_row = next(r for r in rows if r['name'] == 'fps')
    rec['head_fps_share_of_forward'] = fps_row[f'{label}_head_ms'] / rec['forward_ms']['median']
    log(f'# {label}: the head\'s two B2 calls take {fps_row[f"{label}_head_ms"]:.3f} ms, '
        f'{rec["head_fps_share_of_forward"]:.1%} of the forward (chain floor '
        f'{fps_row[f"{label}_head_chain_floor_ms"]:.3f} ms); the backbone\'s four '
        f'{fps_row[f"{label}_backbone_ms"]:.3f} ms')
    rec['ball_queries'] = ball_query_stats(model, lambda: forward(model, batch), label)
    del model, batch
    torch.cuda.empty_cache()
    return rec


def kitti_pointrcnn_train_phase(kernels, rows):
    """PointRCNN training on data/kitti's first BATCH train samples (gt
    sampling and every augmentation; FIXTURE_CLASSES), the gt boxes among
    the proposals (`gt_proposals`): 2 + 5 bf16 steps of pointrcnn.yaml (B1,
    B2 six times and B3 every step, every loss term finite, the RCNN
    regression above 0 in every step, foreground points and RoIs in the
    first), one more step whose calls are held to the plain versions by
    call site (the head's B2 on B * ROI_PER_IMAGE = 512 rows;
    `kitti_pointrcnn_train_<site>_*` keys); one bf16 step of
    pointrcnn_iou_car.yaml (finite terms, regression above 0); then
    fv2p_torch.tools.test over the 24 val scans with seeded weights,
    counted (B1, B2, B3), its calls held to the plain versions
    (`kitti_pointrcnn_test_*` keys), the AP dict produced and finite.
    Returns the record."""
    import yaml
    from fv2p_torch.datasets import dataset_meta_from_cfg
    from fv2p_torch.ops import cuda as kcuda
    label = 'kitti_pointrcnn_train'
    cfg = load_cfg(POINTRCNN_CFG)
    cfg.CLASS_NAMES = list(FIXTURE_CLASSES)
    tmeta = dataset_meta_from_cfg(cfg.DATA_CONFIG, 'train')
    batch = fixture_batch(cfg, training=True)
    rec = {'gt_boxes': int((batch['gt_boxes'][..., 7] > 0).sum()),
           'points_per_scan': batch['points_valid'].sum(1).tolist()}
    step = make_train_step(cfg, tmeta, torch.bfloat16)
    hook = gt_proposals(step.model.point_head)
    trec = rec['train'] = timed_train_steps(kcuda, step, batch, POINTRCNN_LAUNCHED,
                                            pointrcnn_train_targets)
    first = trec['first_step_targets']
    if first['foreground_points'] <= 0 or first['foreground_rois'] <= 0:
        fail(f'{label}: first step targets {first}')
    if not all(x > 0 for x in trec['loss_terms']['rcnn_loss_reg']):
        fail(f'{label}: rcnn_loss_reg {trec["loss_terms"]["rcnn_loss_reg"]}')
    if any(n['fps'] != 6 or n['three_nn'] != 4 for n in trec['launches_per_step']):
        fail(f'{label}: launches per step {trec["launches_per_step"]}')
    log(f'# {label} bf16 step at batch {BATCH} ({rec["gt_boxes"]} gt boxes), ms median '
        f'(quartiles) of {TRAIN_TIMED}: ' + ', '.join(
            f'{k} {v["median"]:.2f} ({v["q1"]:.2f}-{v["q3"]:.2f})' for k, v in trec['ms'].items())
        + f'; peak {trec["peak_mem_gib"]:.2f} GiB; loss '
        f'{[round(x, 3) for x in trec["loss_terms"]["loss"]]}; first step {first}')
    tcalls, rec['launches'] = captured_train_calls(kernels, step, batch, POINTRCNN_LAUNCHED)
    head_rows = sorted({a[0].shape[0] for _, a in tcalls['fps'].calls if a[0].shape[0] > BATCH})
    rois = BATCH * int(cfg.MODEL.ROI_HEAD.TARGET_CONFIG.ROI_PER_IMAGE)
    if head_rows != [rois]:
        fail(f'{label}: the head\'s B2 calls take {head_rows} rows, expected {rois}')
    site_rows(pointrcnn_sites(tcalls, BATCH), kernels, rows, label)
    hook.remove()
    del step, tcalls, batch
    torch.cuda.empty_cache()

    icfg = load_cfg(POINTRCNN_IOU_CAR_CFG)
    istep = make_train_step(icfg, dataset_meta_from_cfg(icfg.DATA_CONFIG, 'train'),
                            torch.bfloat16)
    hook = gt_proposals(istep.model.point_head)
    terms, _, _ = counted_train_step(kcuda, istep, fixture_batch(icfg, training=True),
                                     POINTRCNN_LAUNCHED)
    hook.remove()
    rec['iou_car_terms'] = {k: float(v) for k, v in terms.items()}
    if not all(np.isfinite(v) for v in rec['iou_car_terms'].values()) or \
            rec['iou_car_terms']['rcnn_loss_reg'] <= 0:
        fail(f'{label}: pointrcnn_iou_car.yaml step terms {rec["iou_car_terms"]}')
    log(f'# {label}: pointrcnn_iou_car.yaml bf16 step terms {rec["iou_car_terms"]}')
    del istep
    torch.cuda.empty_cache()

    out = REPO / 'output' / 'chip_smoke' / 'kitti_pointrcnn'
    out.mkdir(parents=True, exist_ok=True)
    cfg_d = yaml.safe_load(POINTRCNN_CFG.read_text())
    cfg_d['CLASS_NAMES'] = list(FIXTURE_CLASSES)
    cfg_d['DATA_CONFIG']['_BASE_CONFIG_'] = str(
        REPO / 'tools' / cfg_d['DATA_CONFIG']['_BASE_CONFIG_'])
    cfg_d['DATA_CONFIG']['DATA_PATH'] = str(KITTI)
    cfg_file = out / 'pointrcnn_car_pedestrian.yaml'
    cfg_file.write_text(yaml.safe_dump(cfg_d))
    t0 = time.perf_counter()
    ret, rec['test_launches'], _ = counted_test_run(
        kernels, rows, 'kitti_pointrcnn_test',
        ['--cfg_file', str(cfg_file), '--workers', str(SHORT_RUN_WORKERS), '--output_dir',
         str(out)], POINTRCNN_LAUNCHED)
    rec['test_s'] = time.perf_counter() - t0
    ap = {k: v for k, v in ret.items() if k.startswith('Car_3d/')}
    if not ap or any(not np.isfinite(v) for v in ret.values()):
        fail(f'{label}: no Car AP or a test result not finite: {ret}')
    rec['test'] = {k: ret[k] for k in ('sec_per_example', 'loader_wait_s_per_batch',
                                       'forward_ms_median')}
    rec['test_ap_car_3d'] = ap
    log(f'# kitti_pointrcnn_test: {rec["test_s"]:.1f} s over the val scans, '
        f'{ret["sec_per_example"] * 1e3:.2f} ms a scan, forward median '
        f'{ret["forward_ms_median"]:.2f} ms a batch; launches {rec["test_launches"]}; {ap}')
    return rec


# ------------------------------------------------------------- PartA2

PARTA2_CFG = REPO / 'tools' / 'cfgs' / 'kitti_models' / 'PartA2.yaml'
PARTA2_CAR_CFG = REPO / 'tools' / 'cfgs' / 'kitti_models' / 'PartA2_car.yaml'
PARTA2_FREE_CFG = REPO / 'tools' / 'cfgs' / 'kitti_models' / 'PartA2_free.yaml'
WAYMO_PARTA2_CFG = WAYMO_CFGS / 'PartA2.yaml'
# the PartA2 family launches B1 alone: proposal NMS, the RoI sampling's 3D
# IoU, the final NMS, the recall counter and the evaluator
PARTA2_LAUNCHED = ('rotated_iou',)
# kitti_parta2_train's runner runs: the train split's first scans, at batch
# 1 for the profiled run (steps 2 and 3 of 4) and one step of 4 for the other
PARTA2_RUNNER_SCANS = 4


# the classes of data/waymo's objects (its gt database has no Cyclist, and the
# gt sampler, as JAX's, fails on a class of no entries)
WAYMO_FIXTURE_CLASSES = ['Vehicle', 'Pedestrian']


def fixture_model_cfg(model_cfg, class_names, caps=None):
    """A PartA2 yaml's MODEL for a fixture (in place): the anchor generator's
    entries of `class_names` alone, and `caps` as its LEVEL_CAPACITIES."""
    head = model_cfg.get('DENSE_HEAD')
    if head is not None:
        head['ANCHOR_GENERATOR_CONFIG'] = [a for a in head['ANCHOR_GENERATOR_CONFIG']
                                           if a['class_name'] in class_names]
    if caps is not None:
        model_cfg['BACKBONE_3D']['LEVEL_CAPACITIES'] = caps
    return model_cfg


def fixture_classes(cfg, training):
    """`cfg` (a config, or a yaml's dict) cut to its classes among
    FIXTURE_CLASSES, with `kitti_train_caps` in training
    (`fixture_model_cfg`)."""
    cfg['CLASS_NAMES'] = [c for c in cfg['CLASS_NAMES'] if c in FIXTURE_CLASSES]
    fixture_model_cfg(cfg['MODEL'], cfg['CLASS_NAMES'],
                      kitti_train_caps() if training else None)
    return cfg


def fixture_cfg_file(path, out, n_train=None):
    """The yaml at `path` for the runners on data/kitti (`fixture_classes`,
    fv2p.yaml's level capacities) written into `out`; with `n_train` the
    train split cut to its first n_train scans."""
    import pickle
    import yaml
    cfg_d = fixture_classes(yaml.safe_load(path.read_text()), training=True)
    cfg_d['DATA_CONFIG']['_BASE_CONFIG_'] = str(
        REPO / 'tools' / cfg_d['DATA_CONFIG']['_BASE_CONFIG_'])
    cfg_d['DATA_CONFIG']['DATA_PATH'] = str(KITTI)
    if n_train is not None:
        with open(KITTI / 'kitti_infos_train.pkl', 'rb') as f:
            infos = pickle.load(f)[:n_train]
        info = out / f'kitti_infos_train_first{n_train}.pkl'
        info.write_bytes(pickle.dumps(infos))
        cfg_d['DATA_CONFIG']['INFO_PATH'] = {'train': [str(info)],
                                             'test': [str(KITTI / 'kitti_infos_val.pkl')]}
    cfg_file = out / f'{path.stem}_fixture.yaml'
    cfg_file.write_text(yaml.safe_dump(cfg_d))
    return cfg_file


def parta2_roi_times(model, run):
    """ms of the RoI head's parts in one run() (CUDA events): the proposal
    NMS (and in training the RoI sampling), RoI-aware pooling of both grids,
    the four masked conv blocks, the FC layers with the decode."""
    head = model.roi_head
    names = ('start', 'pool0', 'pool1', 'convs', 'end')
    ev = {k: torch.cuda.Event(enable_timing=True) for k in names}
    orig = head.pooled_grids

    def pooled(bd):
        ev['pool0'].record()
        grids = orig(bd)
        ev['pool1'].record()
        return grids
    handles = [head.register_forward_pre_hook(lambda m, a: ev['start'].record()),
               head.rpn_conv2.register_forward_hook(lambda m, a, o: ev['convs'].record()),
               head.register_forward_hook(lambda m, a, o: ev['end'].record())]
    head.pooled_grids = pooled
    try:
        sync()
        run()
        sync()
    finally:
        del head.pooled_grids
        for h in handles:
            h.remove()
    return {part: ev[a].elapsed_time(ev[b]) for part, a, b in (
        ('proposals', 'start', 'pool0'), ('roiaware_pool', 'pool0', 'pool1'),
        ('conv_stack', 'pool1', 'convs'), ('fc_and_decode', 'convs', 'end'))}


def roiaware_pool_stats(model, batch, label):
    """The forward's two `roiaware_pool3d_batch` calls alone ('avg' of the
    part features, 'max' of the point features) on their captured inputs:
    time (CUDA events, mean of 5), the memory they take beyond their inputs,
    and the byte bound (every input read once, the grid written once, at
    HBM_BYTES_S); the (RoI, point) pairs and channels."""
    from fv2p_torch.models.roi_heads import partA2_head
    from fv2p_torch.ops import roiaware_pool
    calls = []
    orig = partA2_head.roiaware_pool3d_batch

    def rec(*a):
        calls.append(a)
        return orig(*a)
    partA2_head.roiaware_pool3d_batch = rec
    try:
        forward(model, batch)
        sync()
    finally:
        partA2_head.roiaware_pool3d_batch = orig
    out = {}
    for pts, feats, valid, rois, s, method in calls:
        def fn(a=(pts, feats, valid, rois, s, method)):
            return roiaware_pool.roiaware_pool3d_batch(*a)
        ms = time_events(fn, reps=5)
        sync()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        grid = fn()
        sync()
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        n_bytes = sum(t.numel() * t.element_size() for t in (pts, feats, valid, rois)) \
            + grid.numel() * grid.element_size()
        out[method] = {'ms': ms, 'transient_gib': peak, 'bound_ms': n_bytes / HBM_BYTES_S * 1e3,
                       'pairs': int(rois.shape[0] * rois.shape[1] * pts.shape[1]),
                       'channels': int(feats.shape[-1]), 'grid_shape': list(grid.shape)}
        del grid
    log(f'# {label} RoI-aware pooling alone: ' + '; '.join(
        f'{m} {r["ms"]:.3f} ms over {r["pairs"]} pairs x {r["channels"]} channels, '
        f'{r["transient_gib"]:.3f} GiB beyond its inputs, byte bound {r["bound_ms"]:.4f} ms'
        for m, r in out.items()))
    return out


def parta2_train_targets(out):
    """Foreground counts of one PartA2 train forward: positive anchors (none
    for PartA2_free), foreground points, foreground (regressed) RoIs and
    the sampled RoIs."""
    rec = {'foreground_points': int((out['point_head_ret']['point_cls_labels'] > 0).sum()),
           'foreground_rois': int(out['roi_head_ret']['reg_valid_mask'].sum()),
           'sampled_rois': int(out['roi_head_ret']['reg_valid_mask'].numel())}
    if 'anchor_head_ret' in out:
        rec['positive_anchors'] = int((out['anchor_head_ret']['box_cls_labels'] > 0).sum())
    return rec


def proposal_head(model):
    """The module whose forward leaves the proposals: the anchor head, or
    PartA2_free's part head."""
    return model.dense_head if hasattr(model, 'dense_head') else model.point_head


def parta2_eval(kernels, rows, label, cfg, meta, batch, later, batch_size):
    """A PartA2 yaml's bf16 forward at full width on `batch`, BatchNorm
    calibrated, counted (B1 alone, at least twice a scan), its calls held to
    the plain version and timed (`label`_* keys), the NMS keeps identical
    on both routes. Returns (record, model, post)."""
    model = make_model(cfg, meta, torch.bfloat16, calibrate_on=batch)
    rec = {'parameters': sum(p.numel() for p in model.parameters()),
           'voxels_per_scan': batch['voxel_valid'].sum(1).tolist()}
    post = int(cfg.MODEL.POST_PROCESSING.NMS_CONFIG.NMS_POST_MAXSIZE)
    head_io = {}
    hook = proposal_head(model).register_forward_hook(lambda m, a, o: head_io.update(
        box=o['batch_box_preds'].clone(), cls=o['batch_cls_preds'].clone()))
    out, calls, launches = counted_forward(kernels, model, batch, label, PARTA2_LAUNCHED)
    hook.remove()
    rec['launches'] = launches
    if launches['rotated_iou'] < 2 * batch_size:
        fail(f'{label}: B1 launched {launches["rotated_iou"]} times, expected at least '
             f'{2 * batch_size}')
    keys = ('batch_box_preds', 'batch_cls_preds', 'point_features', 'point_part_offset')
    rec['valid_detections'] = check_outputs(out, post, keys, batch_size)
    rec['proposals'] = grid_nms_keeps(kernels, model, label, head_io, out)
    rec['point_rows'] = out['point_valid'].sum(1).tolist()
    log(f'# {label}: {rec["parameters"]} parameters, {rec["voxels_per_scan"]} voxels a scan, '
        f'{rec["valid_detections"]} valid detections over {batch_size} scans; B1 calls '
        f'{[list(a[0].shape) for _, a in calls["rotated_iou"].calls][:6]}...')
    del out, head_io
    train_kernel_rows(calls, launches, rows, prefix=label)
    later.append((label, calls['rotated_iou']))
    return rec, model, post


def _parta2_f32_step(step, batch, kernels):
    """Loss terms, gradients, proposal keeps and sampled RoIs of one f32
    train step, through the plain versions when `kernels` is given."""
    from fv2p_torch.models.roi_heads import pvrcnn_head
    props = []
    prop_fn = pvrcnn_head.proposal_layer

    def prop_rec(*a):
        props.append(prop_fn(*a))
        return props[-1]
    pvrcnn_head.proposal_layer = prop_rec
    try:
        terms, grads, out = _zoo_f32_step(step, batch, kernels)
    finally:
        pvrcnn_head.proposal_layer = prop_fn
    return terms, grads, props, out['roi_head_ret']['rois_sampled'].detach()


def parta2_one_step(kernels, label, path):
    """One counted bf16 train step of the yaml at `path` (`fixture_classes`)
    on the fixture's first BATCH train samples, the gt among the proposals:
    every loss term finite, foreground RoIs, the RCNN regression above 0.
    Returns the terms and targets."""
    from fv2p_torch.datasets import dataset_meta_from_cfg
    from fv2p_torch.ops import cuda as kcuda
    cfg = fixture_classes(load_cfg(path), training=True)
    step = make_train_step(cfg, dataset_meta_from_cfg(cfg.DATA_CONFIG, 'train'),
                           torch.bfloat16)
    hook = gt_proposals(proposal_head(step.model))
    terms, _, out = counted_train_step(kcuda, step, fixture_batch(cfg, training=True),
                                       PARTA2_LAUNCHED, keep_out=True)
    hook.remove()
    rec = {'terms': {k: float(v) for k, v in terms.items()},
           'targets': parta2_train_targets(out)}
    if not all(np.isfinite(v) for v in rec['terms'].values()) or \
            rec['terms']['rcnn_loss_reg'] <= 0 or rec['targets']['foreground_rois'] <= 0:
        fail(f'{label}: {path.name} step {rec}')
    log(f'# {label}: {path.name} bf16 step terms {rec["terms"]}; targets {rec["targets"]}')
    del step, out
    torch.cuda.empty_cache()
    return rec


def kitti_parta2_phase(kernels, rows, later):
    """kitti_models/PartA2.yaml at full width on the first BATCH val scans of
    data/kitti through KittiDataset (the 40000-voxel test cap, host tables
    at the derived level capacities), bf16, BatchNorm calibrated: counted
    (B1 alone), every call held to the plain version and timed
    (`kitti_parta2_*` keys), NMS keeps identical, the f32 forward through
    the kernel against the plain version; the forward's median, per module,
    the RoI head by part, peak memory, and RoI-aware pooling alone beside
    its byte bound. Returns the record."""
    from fv2p_torch.datasets import dataset_meta_from_cfg
    label = 'kitti_parta2'
    cfg = load_cfg(PARTA2_CFG)
    meta = dataset_meta_from_cfg(cfg.DATA_CONFIG, 'test')
    batch = fixture_batch(cfg, training=False)
    rec, model, post = parta2_eval(kernels, rows, label, cfg, meta, batch, later, BATCH)
    rec['f32_kernel_vs_plain_max_abs'] = f32_forward(
        kernels, cfg, meta, batch, post,
        ('batch_box_preds', 'batch_cls_preds', 'point_features', 'point_part_offset'), label,
        ('pred_boxes', 'pred_scores', 'batch_box_preds', 'batch_cls_preds'), calibrate=True)
    rec.update(forward_stats(model, batch, label))
    passes = [parta2_roi_times(model, lambda: forward(model, batch)) for _ in range(MODULE_REPS)]
    rec['roi_head_ms'] = {k: float(np.median([p[k] for p in passes])) for k in passes[0]}
    log(f'# {label} roi_head by part (ms, median of {MODULE_REPS}): '
        f'{ {k: round(v, 3) for k, v in rec["roi_head_ms"].items()} }')
    rec['roiaware_pool'] = roiaware_pool_stats(model, batch, label)
    rec['host_syncs'], rec['host_sync_sites'] = host_syncs(lambda: forward(model, batch))
    log(f'# {label} host waits in one forward: {rec["host_syncs"]}; by line: '
        f'{rec["host_sync_sites"]}')
    del model, batch
    torch.cuda.empty_cache()
    return rec


def kitti_parta2_train_phase(kernels, rows):
    """PartA2 training on data/kitti's first BATCH train samples (gt
    sampling and every augmentation, the 16000-voxel train cap; PartA2.yaml
    cut to FIXTURE_CLASSES and their anchors, at fv2p.yaml's train level
    capacities: `fixture_classes`), jittered gt boxes among the
    proposals (`gt_proposals` on the anchor head): an f32 step through the
    kernel and through the plain version under `deterministic` (proposal
    keeps and sampled RoIs identical, loss terms and gradients as FV2P's:
    without it, RoI-aware pooling's 'avg' sums and cuDNN's 3D weight
    gradients add in no fixed order, and single gradient tensors part by
    up to 6e-4 of their largest element), 2 + 5 bf16 steps (B1
    every step, every loss term finite, the RCNN regression above 0 every
    step, foreground points and RoIs in the first), the train step per
    module and the RoI head by part, one more step's calls held to the
    plain version (`kitti_parta2_train_*` keys); one bf16 step each of
    PartA2_car.yaml and PartA2_free.yaml; fv2p_torch.tools.test over the 24
    val scans (`kitti_parta2_test_*` keys, AP finite); and the train runner
    on the train split's first PARTA2_RUNNER_SCANS scans of PartA2_car.yaml:
    OPTIMIZER sgd at batch 1 with --profile_steps 2,3 (the trace must hold
    CUDA kernel events), then OPTIMIZER adam, one step at batch 4 (peak LR
    KITTI_TRAIN_LR in both, C3). Returns the record."""
    import json as json_
    import shutil
    from fv2p_torch.datasets import dataset_meta_from_cfg
    from fv2p_torch.ops import cuda as kcuda
    from fv2p_torch.tools import train as train_runner
    label = 'kitti_parta2_train'
    cfg = fixture_classes(load_cfg(PARTA2_CFG), training=True)
    tmeta = dataset_meta_from_cfg(cfg.DATA_CONFIG, 'train')
    batch = fixture_batch(cfg, training=True)
    rec = {'gt_boxes': int((batch['gt_boxes'][..., 7] > 0).sum()),
           'voxels_per_scan': batch['voxel_valid'].sum(1).tolist()}
    with full_f32(), deterministic():
        step = make_train_step(cfg, tmeta, None)
        hook = gt_proposals(step.model.dense_head)
        tk, gk, nk, rk = _parta2_f32_step(step, batch, None)
        tp, gp, np_, rp = _parta2_f32_step(step, batch, kernels)
        hook.remove()
    if len(nk) != 1 or not all(torch.equal(a, b) for a, b in zip(nk[0], np_[0])):
        fail(f'{label} f32 step: proposal NMS keeps differ between kernel and plain')
    if not torch.equal(rk, rp):
        fail(f'{label} f32 step: sampled RoIs differ between kernel and plain')
    frec = rec['f32_kernel_vs_plain'] = compare_train_steps(f'{label} f32 step', tk, tp, gk,
                                                            gp)
    log(f'# {label} f32 step (deterministic algorithms), kernel vs plain version: proposal '
        f'keeps and sampled RoIs identical; loss terms max relative difference '
        f'{max(frec["loss_rel_diff"].values()):.3g}; worst gradient '
        f'{frec["grad_worst_rel_to_max"]:.3g} of its max')
    del step
    torch.cuda.empty_cache()

    step = make_train_step(cfg, tmeta, torch.bfloat16)
    hook = gt_proposals(step.model.dense_head)
    trec = rec['train'] = timed_train_steps(kcuda, step, batch, PARTA2_LAUNCHED,
                                            parta2_train_targets)
    first = trec['first_step_targets']
    if first['foreground_points'] <= 0 or first['foreground_rois'] <= 0:
        fail(f'{label}: first step targets {first}')
    if not all(x > 0 for x in trec['loss_terms']['rcnn_loss_reg']):
        fail(f'{label}: rcnn_loss_reg {trec["loss_terms"]["rcnn_loss_reg"]}')
    log(f'# {label} bf16 step at batch {BATCH} ({rec["gt_boxes"]} gt boxes), ms median '
        f'(quartiles) of {TRAIN_TIMED}: ' + ', '.join(
            f'{k} {v["median"]:.2f} ({v["q1"]:.2f}-{v["q3"]:.2f})' for k, v in trec['ms'].items())
        + f'; peak {trec["peak_mem_gib"]:.2f} GiB; loss '
        f'{[round(x, 3) for x in trec["loss_terms"]["loss"]]}; first step {first}')
    passes = [module_times(step.model, lambda: step.step(batch), tail='loss_backward_optimizer')
              for _ in range(MODULE_REPS)]
    trec['per_module_ms'] = {m: float(np.median([p[m] for p in passes])) for m in passes[0]}
    passes = [parta2_roi_times(step.model, lambda: step.step(batch)) for _ in range(MODULE_REPS)]
    trec['roi_head_ms'] = {k: float(np.median([p[k] for p in passes])) for k in passes[0]}
    log(f'# {label} step per module (ms, median of {MODULE_REPS}): '
        f'{ {k: round(v, 2) for k, v in trec["per_module_ms"].items()} }; roi_head forward '
        f'by part {({k: round(v, 3) for k, v in trec["roi_head_ms"].items()})}')
    tcalls, rec['launches'] = captured_train_calls(kernels, step, batch, PARTA2_LAUNCHED)
    train_kernel_rows(tcalls, rec['launches'], rows, prefix=label)
    hook.remove()
    del step, tcalls, batch
    torch.cuda.empty_cache()

    rec['car_step'] = parta2_one_step(kernels, label, PARTA2_CAR_CFG)
    rec['free_step'] = parta2_one_step(kernels, label, PARTA2_FREE_CFG)

    out = REPO / 'output' / 'chip_smoke' / 'kitti_parta2'
    out.mkdir(parents=True, exist_ok=True)
    cfg_file = fixture_cfg_file(PARTA2_CFG, out)
    t0 = time.perf_counter()
    ret, rec['test_launches'], _ = counted_test_run(
        kernels, rows, 'kitti_parta2_test',
        ['--cfg_file', str(cfg_file), '--workers', str(SHORT_RUN_WORKERS), '--output_dir',
         str(out / 'test')], PARTA2_LAUNCHED)
    rec['test_s'] = time.perf_counter() - t0
    ap = {k: v for k, v in ret.items() if k.startswith('Car_3d/')}
    if not ap or any(not np.isfinite(v) for v in ret.values()):
        fail(f'{label}: no Car AP or a test result not finite: {ret}')
    rec['test'] = {k: ret[k] for k in ('sec_per_example', 'loader_wait_s_per_batch',
                                       'forward_ms_median')}
    rec['test_ap_car_3d'] = ap
    log(f'# kitti_parta2_test: {rec["test_s"]:.1f} s over the val scans, '
        f'{ret["sec_per_example"] * 1e3:.2f} ms a scan, forward median '
        f'{ret["forward_ms_median"]:.2f} ms a batch; launches {rec["test_launches"]}; {ap}')

    # the runner's optimizers and --profile_steps on the card
    car_file = fixture_cfg_file(PARTA2_CAR_CFG, out, n_train=PARTA2_RUNNER_SCANS)
    runs = {}
    for name, extra in (('sgd', ['--batch_size', '1', '--profile_steps', '2,3']),
                        ('adam', ['--batch_size', str(PARTA2_RUNNER_SCANS)])):
        run_dir = out / f'runner_{name}'
        shutil.rmtree(run_dir, ignore_errors=True)     # a checkpoint there would resume
        t0 = time.perf_counter()
        run = train_runner.main(['--cfg_file', str(car_file), '--workers',
                                 str(SHORT_RUN_WORKERS), '--epochs', '1', '--output_dir',
                                 str(run_dir), *extra, '--set', 'OPTIMIZATION.OPTIMIZER', name,
                                 'OPTIMIZATION.LR', str(KITTI_TRAIN_LR)])
        sync()
        steps = run['steps']
        state = run['trainer'].optimizer.state_dict()
        runs[name] = {'steps': len(steps), 'loss': [s['loss'] for s in steps],
                      'wall_s': time.perf_counter() - t0,
                      'state': sorted(k for k in state if k != 'count')}
        want_state = ['trace'] if name == 'sgd' else ['mu', 'nu']
        if not steps or any(not np.isfinite(v) for s in steps for v in s.values()) or \
                runs[name]['state'] != want_state:
            fail(f'{label} runner {name}: {runs[name]}')
        if name == 'sgd':
            trace = run.get('profile')
            if trace is None or not trace.exists():
                fail(f'{label}: --profile_steps 2,3 wrote no trace')
            events = json_.loads(trace.read_text())['traceEvents']
            kernels_in = [e for e in events if e.get('cat') == 'kernel']
            runs[name].update(trace=str(trace.relative_to(REPO)),
                              trace_mb=trace.stat().st_size / 2 ** 20,
                              trace_cuda_kernels=len(kernels_in),
                              trace_b1_kernels=sum('overlap_kernel' in e.get('name', '')
                                                   for e in kernels_in))
            if not kernels_in:
                fail(f'{label}: the --profile_steps trace holds no CUDA kernel event')
        del run
    rec['runner'] = runs
    log(f'# {label} runner: ' + '; '.join(
        f'{n}: {r["steps"]} steps, loss {[round(x, 3) for x in r["loss"]]}, state {r["state"]}'
        for n, r in runs.items())
        + f'; --profile_steps 2,3 trace {runs["sgd"]["trace_mb"]:.1f} MB, '
        f'{runs["sgd"]["trace_cuda_kernels"]} CUDA kernel events '
        f'({runs["sgd"]["trace_b1_kernels"]} of B1)')
    torch.cuda.empty_cache()
    return rec


def waymo_parta2_phase(kernels, rows, later):
    """waymo_models/PartA2.yaml at full width in bf16 on WAYMO_BATCH val
    frames of data/waymo (the 90000-voxel test cap, host tables at
    waymo_fv2p_e30.yaml's level capacities, as waymo_pv_rcnn: the yaml sets
    none, and the derived x_conv3 cap is under the rows these frames fill
    there), BatchNorm calibrated: counted (B1 alone),
    every call held to the plain version and timed (`waymo_parta2_*` keys),
    NMS keeps identical, the forward's median, per module, the RoI head by
    part and RoI-aware pooling alone; then one counted bf16 train step on
    WAYMO_BATCH train samples (gt sampling, the 80000-voxel cap; the yaml
    cut to WAYMO_FIXTURE_CLASSES and their anchors), the gt among the
    proposals: every loss term finite, the RCNN regression above 0. Returns
    the record."""
    from fv2p_torch.datasets import dataset_meta_from_cfg
    from fv2p_torch.ops import cuda as kcuda
    label = 'waymo_parta2'
    cfg = load_cfg(WAYMO_PARTA2_CFG)
    cfg.MODEL.BACKBONE_3D.LEVEL_CAPACITIES = load_cfg(
        WAYMO_FV2P_CFG).MODEL.BACKBONE_3D.LEVEL_CAPACITIES
    meta = dataset_meta_from_cfg(cfg.DATA_CONFIG, 'test')
    batch, rec_caps = waymo_batch(cfg, training=False)
    rec, model, _ = parta2_eval(kernels, rows, label, cfg, meta, batch, later, WAYMO_BATCH)
    rec['max_active_rows'] = rec_caps
    rec.update(forward_stats(model, batch, label, WAYMO_BATCH))
    rec['roi_head_ms'] = parta2_roi_times(model, lambda: forward(model, batch))
    log(f'# {label} roi_head by part (ms): '
        f'{ {k: round(v, 3) for k, v in rec["roi_head_ms"].items()} }')
    rec['roiaware_pool'] = roiaware_pool_stats(model, batch, label)
    del model, batch
    torch.cuda.empty_cache()

    cfg.CLASS_NAMES = [c for c in cfg.CLASS_NAMES if c in WAYMO_FIXTURE_CLASSES]
    fixture_model_cfg(cfg.MODEL, cfg.CLASS_NAMES)
    tbatch, _ = waymo_batch(cfg, training=True)
    step = make_train_step(cfg, dataset_meta_from_cfg(cfg.DATA_CONFIG, 'train'),
                           torch.bfloat16)
    hook = gt_proposals(step.model.dense_head)
    torch.cuda.reset_peak_memory_stats()
    terms, _, out = counted_train_step(kcuda, step, tbatch, PARTA2_LAUNCHED, keep_out=True)
    sync()
    hook.remove()
    rec['train'] = {'terms': {k: float(v) for k, v in terms.items()},
                    'targets': parta2_train_targets(out),
                    'peak_mem_gib': torch.cuda.max_memory_allocated() / 2 ** 30}
    if not all(np.isfinite(v) for v in rec['train']['terms'].values()) or \
            rec['train']['terms']['rcnn_loss_reg'] <= 0:
        fail(f'{label} train step: {rec["train"]}')
    log(f'# {label} bf16 train step at batch {WAYMO_BATCH}: terms {rec["train"]["terms"]}; '
        f'targets {rec["train"]["targets"]}; peak {rec["train"]["peak_mem_gib"]:.2f} GiB')
    del step, out, tbatch
    torch.cuda.empty_cache()
    return rec


# ------------------------------------------------------ data parallel

DDP_TRAIN_SCANS = 8          # the torchrun run's train split: 4 steps at batch 2
DDP_GLOBAL_BATCH = 4         # (b): two ranks of 2 scans on the one card
# (a): the first step's terms of the two runs must agree to this relative
# difference, later steps (what an operation without a deterministic
# implementation leaves, amplified by Adam) to DDP_LATER_REL
DDP_FIRST_REL, DDP_LATER_REL = 1e-5, 1e-3


# ddp (a)'s training runs: the runner under PyTorch's deterministic
# algorithms (a warning where an operation has none) and cuDNN's
# deterministic convolutions, so that float atomics add in a fixed order
# (memory that an operation leaves unwritten is not filled, as in every
# other run). Without them the two runs agreed to the bit in a process that had done
# nothing else on the card, and parted from their third step after the
# other phases
DETERMINISTIC_TRAIN = """import runpy
import sys

import torch

sys.path.insert(0, {repo!r})
torch.use_deterministic_algorithms(True, warn_only=True)
torch.utils.deterministic.fill_uninitialized_memory = False
torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
runpy.run_module('fv2p_torch.tools.train', run_name='__main__', alter_sys=True)
"""


def ddp_cfg_file(out):
    """fv2p.yaml on data/kitti (the peak learning rate at KITTI_TRAIN_LR, as
    kitti_train) with the train split cut to its first DDP_TRAIN_SCANS
    scans, written into `out`."""
    import pickle
    import yaml
    cfg_d = yaml.safe_load(CFG.read_text())
    cfg_d['DATA_CONFIG']['_BASE_CONFIG_'] = str(
        REPO / 'tools' / cfg_d['DATA_CONFIG']['_BASE_CONFIG_'])
    cfg_d['DATA_CONFIG']['DATA_PATH'] = str(KITTI)
    with open(KITTI / 'kitti_infos_train.pkl', 'rb') as f:
        infos = pickle.load(f)[:DDP_TRAIN_SCANS]
    info = out / f'kitti_infos_train_first{DDP_TRAIN_SCANS}.pkl'
    info.write_bytes(pickle.dumps(infos))
    cfg_d['DATA_CONFIG']['INFO_PATH'] = {'train': [str(info)],
                                         'test': [str(KITTI / 'kitti_infos_val.pkl')]}
    cfg_d['OPTIMIZATION']['LR'] = KITTI_TRAIN_LR
    path = out / 'fv2p_fixture.yaml'
    path.write_text(yaml.safe_dump(cfg_d))
    return path


def _gloo_rank(local, world, port, fn, args, result_path):
    """One rank of a gloo group on card 0 (NCCL refuses two ranks on one
    card): fn(*args), rank 0's return value saved to result_path."""
    import torch.distributed as dist
    os.environ.update(RANK=str(local), LOCAL_RANK='0', WORLD_SIZE=str(world),
                      MASTER_ADDR='127.0.0.1', MASTER_PORT=str(port))
    torch.cuda.set_device(0)
    dist.init_process_group('gloo', init_method='env://')
    try:
        out = fn(*args)
        if local == 0:
            torch.save(out, result_path)
    finally:
        dist.destroy_process_group()


def gloo_ranks_on_one_card(fn, world, args, result_path):
    """fn(*args) in `world` spawned processes, all on card 0, joined over
    gloo; returns rank 0's result. A rank that fails ends the others and
    the call fails."""
    import torch.multiprocessing as mp
    from fv2p_torch import parallel
    mp.start_processes(_gloo_rank, nprocs=world, start_method='spawn',
                       args=(world, parallel.free_port(), fn, args, str(result_path)))
    return torch.load(result_path, weights_only=False)


def _flat_state(module):
    """{name: CPU tensor} of the parameters and the BatchNorm statistics."""
    return {k: v.detach().float().cpu().clone() for k, v in module.state_dict().items()}


def _ddp_step_rank(cfg_path):
    """(b), one rank: the f32 FV2P train step of its half of the global
    batch through TrainStep over DDP (gloo); its averaged gradients, then
    its parameters and statistics after the update, and the loss terms."""
    from fv2p_torch import parallel
    from fv2p_torch.datasets import dataset_meta_from_cfg
    cfg = load_cfg(cfg_path)
    meta = dataset_meta_from_cfg(cfg.DATA_CONFIG, 'train')
    batch, _, _ = train_inputs(cfg, meta, DDP_GLOBAL_BATCH, TRAIN_POINTS)
    local = parallel.slice_batch(batch, parallel.global_batch_slice(
        DDP_GLOBAL_BATCH, parallel.rank(), parallel.world_size()))
    with full_f32():
        step = make_train_step(cfg, meta, None)
        step.model = parallel.wrap_model(step.model)
        loss, terms, _ = step.forward_loss(local)
        step.backward(loss)
        grads = {n: p.grad.detach().cpu().clone() for n, p in step.module.named_parameters()}
        step.update()
        sync()
    return {'terms': {k: float(v) for k, v in parallel.mean_over_ranks(terms).items()},
            'grads': grads, 'state': _flat_state(step.module)}


def ddp_halves_reference(cfg_path):
    """(b), the reference: the same step computed in this process, the two
    halves in turn, their gradients, loss terms and new running statistics
    averaged, then one update with the averaged gradients."""
    from fv2p_torch.datasets import dataset_meta_from_cfg
    from fv2p_torch.models.layers import BatchNorm
    from fv2p_torch.ops.sparse.conv import MaskedBatchNorm
    cfg = load_cfg(cfg_path)
    meta = dataset_meta_from_cfg(cfg.DATA_CONFIG, 'train')
    batch, _, _ = train_inputs(cfg, meta, DDP_GLOBAL_BATCH, TRAIN_POINTS)
    from fv2p_torch import parallel
    half = DDP_GLOBAL_BATCH // 2
    grads, terms, stats = [], [], []
    with full_f32():
        for h in range(2):
            local = parallel.slice_batch(batch, slice(h * half, (h + 1) * half))
            step = make_train_step(cfg, meta, None)
            loss, t, _ = step.forward_loss(local)
            step.backward(loss)
            grads.append({n: p.grad.detach().clone() for n, p in step.module.named_parameters()})
            terms.append({k: float(v) for k, v in t.items()})
            stats.append({n: (m.running_mean.clone(), m.running_var.clone())
                          for n, m in step.module.named_modules()
                          if isinstance(m, (BatchNorm, MaskedBatchNorm))})
            if h == 0:
                del step
        for n, p in step.module.named_parameters():
            p.grad = (grads[0][n] + grads[1][n]) / 2
        for n, m in step.module.named_modules():
            if n in stats[0]:
                m.running_mean.copy_((stats[0][n][0] + stats[1][n][0]) / 2)
                m.running_var.copy_((stats[0][n][1] + stats[1][n][1]) / 2)
        avg = {n: p.grad.detach().cpu().clone() for n, p in step.module.named_parameters()}
        before = _flat_state(step.module)
        lr = step.optimizer.hyperparams()[0]
        step.update()
        sync()
    return {'terms': {k: (terms[0][k] + terms[1][k]) / 2 for k in terms[0]},
            'grads': avg, 'state': _flat_state(step.module), 'state0': before, 'lr': lr}


def compare_ddp_step(got, ref, wd):
    """(b): loss terms within 1e-5 relative; every gradient within 1e-4
    max|g| + 1e-7 (a bias that a train-mode BatchNorm normalises away is
    noise under 1e-5 of its conv's kernel gradient on both sides); the
    running statistics within 1e-5 max + 1e-7; every parameter within
    1e-4 max|ref| + 1e-7 of the reference, except where the gradient is
    rounding noise (at most twice its tolerance), whose Adam step of about
    lr sign(g) is held to at most lr on both sides."""
    rel = {k: abs(got['terms'][k] - v) / max(abs(v), 1e-30) for k, v in ref['terms'].items()}
    if max(rel.values()) > 1e-5:
        fail(f'ddp (b): loss terms differ from the two halves in turn: {rel}')
    worst_g = 0.0
    noise = {}
    for n, g in ref['grads'].items():
        gk, gmax = got['grads'][n], float(g.abs().max())
        err = float((gk - g).abs().max())
        if zero_by_construction(n):
            scale = float(ref['grads'][n[:-len('bias')] + 'kernel'].abs().max())
            if max(gmax, float(gk.abs().max())) > 1e-5 * scale:
                fail(f'ddp (b): {n} should be noise, is {gmax}')
            noise[n] = torch.ones_like(g, dtype=torch.bool)
            continue
        if err > 1e-4 * gmax + 1e-7:
            fail(f'ddp (b): averaged gradient {n} differs by {err} > 1e-4 * {gmax} + 1e-7')
        worst_g = max(worst_g, err / (gmax + 1e-30))
        noise[n] = g.abs() <= 2 * (1e-4 * gmax + 1e-7)
    worst_p = worst_s = 0.0
    n_noise = 0
    for n, ref_t in ref['state'].items():
        got_t = got['state'][n]
        if n.endswith('running_mean') or n.endswith('running_var'):
            err = float((got_t - ref_t).abs().max())
            if err > 1e-5 * float(ref_t.abs().max()) + 1e-7:
                fail(f'ddp (b): averaged statistic {n} differs by {err}')
            worst_s = max(worst_s, err / (float(ref_t.abs().max()) + 1e-30))
            continue
        mask = noise[n]
        n_noise += int(mask.sum())
        err = float((got_t - ref_t).abs().masked_fill(mask, 0.0).max())
        if err > 1e-4 * float(ref_t.abs().max()) + 1e-7:
            fail(f'ddp (b): updated parameter {n} differs by {err}')
        p0 = ref['state0'][n]
        for side in (got_t, ref_t):
            move = (side - p0 + ref['lr'] * wd * p0).abs()[mask]
            if move.numel() and float(move.max()) > ref['lr'] * (1 + 1e-4):
                fail(f'ddp (b): parameter {n} moved by {float(move.max())} > lr where its '
                     f'gradient is noise')
        worst_p = max(worst_p, err / (float(ref_t.abs().max()) + 1e-30))
    return {'loss_rel_diff_max': max(rel.values()), 'grad_worst_rel_to_max': worst_g,
            'param_worst_rel_to_max': worst_p, 'stat_worst_rel_to_max': worst_s,
            'noise_elements': n_noise}


def _eval_rank(argv):
    """(c), one rank: the test runner inside the group (it joins it)."""
    from fv2p_torch.tools import test as test_runner
    return test_runner.main(argv)


def kitti_txt_rows(eval_dir):
    """{frame: [(class, numbers)]} of the KITTI-format detection files."""
    out = {}
    for f in sorted(Path(eval_dir).glob('[0-9]*.txt')):
        out[f.name] = [(ln.split()[0], np.array(ln.split()[1:], float))
                       for ln in f.read_text().splitlines()]
    return out


def wrapper_cost(cfg, meta):
    """DDP's cost at one rank over NCCL: bf16 FV2P train steps at batch
    TRAIN_BATCH on FV2P's train batch, plain TrainStep against TrainStep over
    the wrapper (their own seeded weights each), in turns (plain, DDP, DDP,
    plain, twice), CUDA events around each step; the medians and each
    block's. The step is host-bound: a difference within the blocks' spread
    says nothing."""
    import torch.distributed as dist
    from fv2p_torch import parallel
    batch, _, _ = train_inputs(cfg, meta, TRAIN_BATCH, TRAIN_POINTS)
    os.environ.update(RANK='0', LOCAL_RANK='0', WORLD_SIZE='1', MASTER_ADDR='127.0.0.1',
                      MASTER_PORT=str(parallel.free_port()))
    parallel.init_process_group('cuda')
    try:
        steps = {'plain': make_train_step(cfg, meta, torch.bfloat16),
                 'ddp': make_train_step(cfg, meta, torch.bfloat16)}
        steps['ddp'].model = parallel.wrap_model(steps['ddp'].model)
        ms = {'plain': [], 'ddp': []}
        blocks = {'plain': [], 'ddp': []}
        for name in ('plain', 'ddp', 'ddp', 'plain') * 2:
            block = []
            for i in range(TRAIN_WARMUP + TRAIN_TIMED):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                steps[name].step(batch)
                ev[1].record()
                sync()
                if i >= TRAIN_WARMUP:
                    block.append(ev[0].elapsed_time(ev[1]))
            ms[name] += block
            blocks[name].append(float(np.median(block)))
    finally:
        dist.destroy_process_group()
        for key in ('RANK', 'LOCAL_RANK', 'WORLD_SIZE', 'MASTER_ADDR', 'MASTER_PORT'):
            os.environ.pop(key, None)
    out = {k: {'median': float(np.median(v)), 'block_medians': blocks[k], 'all': v}
           for k, v in ms.items()}
    out['wrapper_ms'] = out['ddp']['median'] - out['plain']['median']
    return out


def ddp_phase():
    """Data parallel on the one card, in three parts.
    (a) ``torchrun --standalone --nproc_per_node 1 -m fv2p_torch.tools.train
    --dist`` (NCCL) for one epoch of fv2p.yaml on data/kitti's first
    DDP_TRAIN_SCANS train scans at batch 2, against the same run without
    --dist, both --fix_random_seed and under deterministic algorithms
    (DETERMINISTIC_TRAIN): the loss terms of every step agree
    (DDP_FIRST_REL on the first, DDP_LATER_REL after); and DDP's cost a
    step at one rank (``wrapper_cost``).
    (b) two gloo ranks on the one card (NCCL refuses two ranks on one
    device): one f32 FV2P train step (no TF32) at global batch
    DDP_GLOBAL_BATCH through TrainStep over DDP against this process
    computing the two halves in turn and averaging them
    (``compare_ddp_step``).
    (c) the test runner in two gloo ranks on the card (each joins the group
    it finds) over the 24 val scans in f32, against one rank: the merged
    detection files in dataset order (classes and counts identical,
    numbers within one unit of their 4th decimal) and the recall and AP
    (within 1e-4).
    NCCL at more than one rank is not checked: the machine has one card.
    Returns the record."""
    import json as json_mod
    import shutil
    from fv2p_torch.datasets import dataset_meta_from_cfg
    from fv2p_torch.tools import test as test_runner
    out = REPO / 'output' / 'chip_smoke' / 'ddp'
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    cfg_file = ddp_cfg_file(out)
    rec = {}

    # (a), both runs under deterministic algorithms (DETERMINISTIC_TRAIN)
    launcher = out / 'deterministic_train.py'
    launcher.write_text(DETERMINISTIC_TRAIN.format(repo=str(REPO)))
    common = [str(launcher), '--cfg_file', str(cfg_file), '--workers', '0',
              '--batch_size', '2', '--epochs', '1', '--fix_random_seed']
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=':4096:8')
    runs = {}
    for name, head in (('torchrun', [sys.executable, '-m', 'torch.distributed.run',
                                     '--standalone', '--nproc_per_node', '1']),
                       ('single', [sys.executable])):
        t0 = time.perf_counter()
        extra = ['--dist'] if name == 'torchrun' else []
        proc = subprocess.run(head + common + extra + ['--output_dir', str(out / name)],
                              cwd=REPO, env=env, timeout=600, stdout=subprocess.DEVNULL,
                              stderr=subprocess.PIPE, text=True)
        if proc.returncode:
            sys.stderr.write(proc.stderr)
            fail(f'ddp (a): the {name} run exited with {proc.returncode}')
        runs[name] = [json_mod.loads(ln) for ln in
                      (out / name / 'metrics.jsonl').read_text().splitlines()]
        rec[f'a_{name}_s'] = time.perf_counter() - t0
        rec[f'a_{name}_nondeterministic_ops'] = sorted(set(re.findall(
            r'(\w+) does not have a deterministic implementation', proc.stderr)))
    a, b = runs['torchrun'], runs['single']
    if len(a) != len(b) or len(a) != DDP_TRAIN_SCANS // 2:
        fail(f'ddp (a): {len(a)} steps with --dist, {len(b)} without')
    def term_rel(x, y, k):
        return abs(x[k] - y[k]) / max(abs(y[k]), 1e-30)
    terms = [k for k in b[0] if k not in ('epoch', 'it')]
    worst = [max(terms, key=lambda k: term_rel(x, y, k)) for x, y in zip(a, b)]
    rel = [term_rel(x, y, k) for x, y, k in zip(a, b, worst)]
    rec['a_step_rel_diff'], rec['a_step_worst_term'] = rel, worst
    if rel[0] > DDP_FIRST_REL or max(rel) > DDP_LATER_REL:
        fail(f'ddp (a): loss terms with --dist differ from the run without by {rel} '
             f'(relative, by step; the terms {worst})')
    log(f'# ddp (a): torchrun --nproc_per_node 1 --dist (NCCL) against no --dist, '
        f'deterministic algorithms, {len(a)} steps: largest relative difference of a loss '
        f'term by step {rel}; losses {[round(s["loss"], 4) for s in a]} '
        f'({rec["a_torchrun_s"]:.1f} s and {rec["a_single_s"]:.1f} s a run); operations '
        f'without a deterministic implementation {rec["a_torchrun_nondeterministic_ops"]}')
    cfg = load_cfg(CFG)
    rec['wrapper'] = wrapper_cost(cfg, dataset_meta_from_cfg(cfg.DATA_CONFIG, 'train'))
    w = rec['wrapper']
    log(f'# ddp (a): bf16 train step at batch {TRAIN_BATCH}, median of {4 * TRAIN_TIMED}: '
        f'plain {w["plain"]["median"]:.2f} ms (blocks '
        f'{[round(x, 2) for x in w["plain"]["block_medians"]]}), over DDP (NCCL, one rank) '
        f'{w["ddp"]["median"]:.2f} ms (blocks {[round(x, 2) for x in w["ddp"]["block_medians"]]}): '
        f'the wrapper costs {w["wrapper_ms"]:.2f} ms a step')
    torch.cuda.empty_cache()

    # (b)
    t0 = time.perf_counter()
    got = gloo_ranks_on_one_card(_ddp_step_rank, 2, (str(CFG),), out / 'b_rank0.pt')
    ref = ddp_halves_reference(CFG)
    rec['b'] = compare_ddp_step(got, ref, float(cfg.OPTIMIZATION.WEIGHT_DECAY))
    rec['b']['s'] = time.perf_counter() - t0
    log(f'# ddp (b): two gloo ranks on the card, f32 FV2P step at global batch '
        f'{DDP_GLOBAL_BATCH}, against the two halves in turn: {rec["b"]}')
    del got, ref
    torch.cuda.empty_cache()

    # (c)
    t0 = time.perf_counter()
    argv = ['--cfg_file', str(cfg_file), '--workers', '0', '--batch_size', str(KITTI_BATCH),
            '--dtype', 'float32', '--save_to_file']
    one = test_runner.main(argv + ['--output_dir', str(out / 'c_one')])
    two = gloo_ranks_on_one_card(_eval_rank, 2, (argv + ['--output_dir', str(out / 'c_two')],),
                                 out / 'c_rank0.pt')
    keys = sorted(k for k in one if '/' in k)
    ap_diff = max(abs(two[k] - one[k]) for k in keys)
    txt_one, txt_two = (kitti_txt_rows(out / r / 'eval') for r in ('c_one', 'c_two'))
    if sorted(txt_one) != sorted(txt_two) or len(txt_one) != 24:
        fail(f'ddp (c): {len(txt_two)} detection files from two ranks, {len(txt_one)} from one')
    num_diff, lines = 0.0, 0
    for frame, rows_one in txt_one.items():
        rows_two = txt_two[frame]
        if [r[0] for r in rows_two] != [r[0] for r in rows_one]:
            fail(f'ddp (c): frame {frame}: classes or counts differ between 2 ranks and 1')
        for (_, x), (_, y) in zip(rows_two, rows_one):
            num_diff = max(num_diff, float(np.abs(x - y).max()))
        lines += len(rows_one)
    rec['c'] = {'ap_max_abs_diff': ap_diff, 'txt_max_abs_diff': num_diff, 'detections': lines,
                'keys': len(keys), 's': time.perf_counter() - t0,
                'ap_car_3d': {k: one[k] for k in keys if k.startswith('Car_3d/')}}
    if sorted(two) != sorted(one) or ap_diff > 1e-4 or num_diff > 1.5e-4 or lines == 0:
        fail(f'ddp (c): two ranks against one: {rec["c"]}')
    log(f'# ddp (c): the test runner in two gloo ranks on the card against one rank, '
        f'{lines} detections over 24 scans: files in dataset order, largest difference of '
        f'a number {num_diff}, of {len(keys)} recall and AP values {ap_diff}')
    return rec


T_START = time.perf_counter()


def main():
    if not torch.cuda.is_available():
        log('chip_smoke.py needs a CUDA card; none is available')
        return 2
    if not (REPO / 'fv2p_torch').is_dir() or not CFG.exists() or not MGAF_CFG.exists():
        log('chip_smoke.py must run from a checkout of the repository')
        return 2
    check_kitti_fixture()
    check_nuscenes_fixture()
    check_waymo_fixture()
    sys.path.insert(0, str(REPO))
    from fv2p_torch.datasets import dataset_meta_from_cfg
    from fv2p_torch.ops import cuda as kcuda
    from fv2p_torch.ops.cuda import fps, rotated_iou

    record = {'device': torch.cuda.get_device_name(0),
              'torch': torch.__version__, 'cuda': torch.version.cuda}
    phase_s, lap_t = {}, [time.perf_counter()]

    def lap(name):
        # seconds since the previous lap, under `name` in the record
        now = time.perf_counter()
        phase_s[name] = now - lap_t[0]
        lap_t[0] = now

    smi = nvidia_smi()
    log(f'# card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}')

    # 1. build the kernels (one nvcc per source, in parallel)
    t0 = time.perf_counter()
    built = kcuda.build()
    record['build_s'] = time.perf_counter() - t0
    record['ptxas'] = {n: log_ for n, (_, log_) in built.items()}
    log(f'# built {sorted(built)} in {record["build_s"]:.1f} s')

    kernels = kernel_list()
    bounds = {'rotated_iou': bound_rotated_iou, 'fps': bound_fps,
              'three_nn': bound_three_nn, 'sa_group': bound_sa_group}
    by_name = {k.name: k for k in kernels}
    lap('build')

    # 2-3. the models and the bench batch (built on the host, copied once);
    # MGAF's bench batch is FV2P's: the same meta, the voxels drawn first
    from fv2p_torch.utils.synthetic import batch_to_torch
    cfg, meta, batch_np, host_s = build_inputs()
    mcfg = load_cfg(MGAF_CFG)
    if dataset_meta_from_cfg(mcfg.DATA_CONFIG, 'train') != meta:
        fail('MGAF and FV2P derive different dataset metas: the batch is not shared')
    t0 = time.perf_counter()
    batch = batch_to_torch(batch_np, 'cuda')
    sync()
    record.update(batch_host_s=host_s,
                  batch_to_device_ms=(time.perf_counter() - t0) * 1e3)
    model = make_model(cfg, meta, torch.bfloat16)
    post = int(cfg.MODEL.POST_PROCESSING.NMS_CONFIG.NMS_POST_MAXSIZE)
    log(f'# bench batch built on the host in {host_s:.1f} s; FV2P '
        f'{sum(p.numel() for p in model.parameters())} parameters')

    # 4. the main path, counted: every count is 0 just before, read just after
    head_io = {}
    hook = model.dense_head.register_forward_hook(lambda m, a, o: head_io.update(
        box=o['batch_box_preds'].clone(), cls=o['batch_cls_preds'].clone()))
    kcuda.reset_launch_counts()
    with patched(kernels, capturing):
        out = forward(model, batch)
    sync()
    launches = dict(kcuda.launch_counts)
    hook.remove()
    log(f'# main path launches: {launches}')
    for k in kernels:
        if launches[k.name] == 0:
            fail(f'kernel {k.name} was not launched on the main path')
        if launches[k.name] != len(k.calls):
            fail(f'{k.name}: {launches[k.name]} launches, {len(k.calls)} calls')
    # one FPS, one 3-NN per decoder level (a level that two blocks read is
    # interpolated once), one SA group per IoU-alignment pass; each scan's
    # proposal NMS and final NMS take at least one IoU call
    decoder = model.post_pfe
    want = {'fps': 1, 'sa_group': 2, 'three_nn': len(
        {decoder.model_cfg.INIT_BLOCK.SOURCE, *decoder.sources})}
    for name, n in want.items():
        if launches[name] != n:
            fail(f'{name}: {launches[name]} launches on the main path, expected {n}')
    if launches['rotated_iou'] < 2 * BATCH:
        fail(f'rotated_iou: {launches["rotated_iou"]} launches, expected at '
             f'least {2 * BATCH}')
    n_valid = check_outputs(out, post, FV2P_KEYS)
    log(f'# bf16 forward: {n_valid} valid detections over {BATCH} scans')

    # 5. each kernel against its plain version on the main path's inputs
    compared = {k.name: compare(k) for k in kernels}
    # B1's other two entry points on the main path's boxes: a proposal block
    # against its first boxes, as blocked NMS checks a block against the kept
    # buffer (a scan whose first block fills the buffer never makes that
    # call), as IoU and as plain intersection areas of the same corners
    b1 = by_name['rotated_iou']
    cross = [('iou_bev_cuda', (c[1][0], c[1][0][:KEPT_ROWS].contiguous()))
             for c in b1.calls if c[1][0].shape[0] > KEPT_ROWS]
    cross += [('overlap_matrix_cuda', tuple(x.contiguous() for x in b1_sets(c)[:2]))
              for c in cross]
    record['b1_cross_max_abs_err'], record['b1_cross_ref_max'] = compare(
        b1, [(f'block against its first {KEPT_ROWS} boxes, {c[0]}', c) for c in cross])
    log(f'# rotated_iou: {len(cross)} cross checks (IoU, and areas from corners) '
        f'on the main path\'s boxes agree with the plain version (max abs error '
        f'{record["b1_cross_max_abs_err"]}, largest |plain output| '
        f'{record["b1_cross_ref_max"]})')
    errs = {name: c[0] for name, c in compared.items()}
    record['kernel_ref_max_abs'] = {name: c[1] for name, c in compared.items()}
    log(f'# kernel vs plain max abs error: {errs}; largest |plain output|: '
        f'{record["kernel_ref_max_abs"]}')
    fv2p_nms_keeps(kernels, model, head_io, out, 'fv2p')
    del out, head_io

    # 6. MGAF's main path on the same batch, counted, then B1 against its
    # plain version on MGAF's calls and the final NMS keep lists
    mgaf = make_model(mcfg, meta, torch.bfloat16, calibrate_on=batch)
    mpost = int(mcfg.MODEL.POST_PROCESSING.NMS_CONFIG.NMS_POST_MAXSIZE)
    mrec = {'parameters': sum(p.numel() for p in mgaf.parameters())}
    log(f'# MGAF-3DSSD {mrec["parameters"]} parameters')
    out_m, mgaf_b1, mrec['launches'] = mgaf_main_path(kernels, mgaf, batch)
    mrec['valid_detections'] = check_outputs(out_m, mpost, MGAF_KEYS)
    cand = torch.cat([c[1][0] for c in mgaf_b1.calls])
    mrec['b1_boxes'] = int(cand.shape[0])
    mrec['b1_boxes_nonpositive_extent'] = int((cand[:, 3:5] <= 0).any(-1).sum())
    log(f'# mgaf bf16 forward: {mrec["valid_detections"]} valid detections over '
        f'{BATCH} scans; {mrec["b1_boxes_nonpositive_extent"]} of the '
        f'{mrec["b1_boxes"]} boxes B1 saw have an extent <= 0')
    mrec['b1_max_abs_err'], mrec['b1_ref_max'] = compare(mgaf_b1)
    log(f'# mgaf: B1 agrees with its plain version on its {len(mgaf_b1.calls)} '
        f'calls (max abs error {mrec["b1_max_abs_err"]}, largest |plain output| '
        f'{mrec["b1_ref_max"]})')
    mgaf_nms_keeps(kernels, mgaf, out_m)
    del out_m

    # 7. both forwards in f32 without TF32: kernels against plain versions
    record['f32_kernel_vs_plain_max_abs'] = f32_forward(
        kernels, cfg, meta, batch, post, FV2P_KEYS, 'fv2p',
        ('pred_boxes', 'pred_scores', 'point_features', 'batch_iouscore_preds'))
    mrec['f32_kernel_vs_plain_max_abs'] = f32_forward(
        kernels, mcfg, meta, batch, mpost, MGAF_KEYS, 'mgaf',
        ('pred_boxes', 'pred_scores', 'batch_box_preds', 'batch_iouscore_preds'),
        calibrate=True)

    lap('main_paths')
    # 8. every kernel on the corner cases its design puts at risk
    corner_phase(by_name)
    lap('corner_cases')

    # 9. times: each kernel's calls of one forward, then the whole forwards.
    # Nothing before the timed forwards runs under torch.profiler: once the
    # profiler has been on, every later launch of the process costs the host
    # more, and the forward is host-bound for a quarter of its time.
    rows = []
    for k in kernels:
        ms = time_events(lambda: [k.launch(a) for a in k.calls],
                         reps=3 if k.name == 'fps' else 10)
        plain_ms = k.plain_ms            # from the comparison above (5.)
        lib_ms = None
        if k.name == 'three_nn':
            lib_ms = time_events(lambda: [library_three_nn(a) for a in k.calls],
                                 reps=3)
        b_bytes, b_ops = (sum(x) for x in zip(*(bounds[k.name](a) for a in k.calls)))
        rows.append({'name': k.name, 'route': 'cuda', 'source': k.source,
                     'replaces': k.replaces, 'launches': launches[k.name],
                     'max_abs_err': errs[k.name], 'ms': ms, 'plain_ms': plain_ms,
                     'bound_ms': max(b_bytes, b_ops) * 1e3,
                     'bound_by': 'bytes' if b_bytes >= b_ops else 'operations',
                     'library_ms': lib_ms})
        log(f'# {k.name}: {ms:.3f} ms kernel, {plain_ms:.3f} ms plain, '
            f'bound {rows[-1]["bound_ms"]:.4f} ms ({rows[-1]["bound_by"]})'
            + (f', library {lib_ms:.3f} ms' if lib_ms is not None else ''))
        if k.name == 'fps':
            # the K-1 cluster exchanges alone: what the chain of picks costs
            # with no distance work, beside the rate bound above
            rows[-1]['chain_floor_ms'] = time_events(
                lambda: [fps.fps_chain_floor_cuda(*a) for _, a in k.calls], reps=3)
            log(f'# fps chain floor (exchanges only): '
                f'{rows[-1]["chain_floor_ms"]:.3f} ms')
        if k.name == 'three_nn':
            tile_rows = kcuda.library('three_nn').fv2p_three_nn_tile_rows()
            counts = [b3_tiles_needed(c, k.launch(c)[0][..., 2], tile_rows)
                      for c in k.calls]
            needed, seeded, total = (sum(x) for x in zip(*counts))
            valid_sources = sum(int(c[1][1].sum()) for c in k.calls)
            all_sources = sum(c[1][1].numel() for c in k.calls)
            rows[-1].update(tiles_needed_share=needed / total,
                            tiles_seeded_share=seeded / total, tile_rows=tile_rows,
                            valid_sources=valid_sources, source_rows=all_sources)
            log(f'# three_nn: {valid_sources} valid of {all_sources} source rows '
                f'over {BATCH} scans; tiles of {tile_rows} rows an exact '
                f'tile-pruned search must visit: {needed / total:.4f} of all; '
                f'the kernel visits at most {seeded / total:.4f}')
        if k.name == 'rotated_iou':
            live, pairs = (sum(x) for x in zip(*(b1_survivors(c) for c in k.calls)))
            rows[-1].update(surviving_pair_share=live / pairs, pairs=pairs)
            log(f'# rotated_iou: {live} of {pairs} pairs survive the cull '
                f'({live / pairs:.4f})')
    # B1 on MGAF's calls: one forward's launches, replayed
    b_bytes, b_ops = (sum(x) for x in zip(*(bound_rotated_iou(a) for a in mgaf_b1.calls)))
    mrec['b1'] = {'launches': mrec['launches']['rotated_iou'],
                  'ms': time_events(lambda: [mgaf_b1.launch(a) for a in mgaf_b1.calls],
                                    reps=10),
                  'plain_ms': mgaf_b1.plain_ms,
                  'bound_ms': max(b_bytes, b_ops) * 1e3,
                  'bound_by': 'bytes' if b_bytes >= b_ops else 'operations',
                  'max_abs_err': mrec['b1_max_abs_err']}
    live, pairs = (sum(x) for x in zip(*(b1_survivors(c) for c in mgaf_b1.calls)))
    mrec['b1'].update(surviving_pair_share=live / pairs, pairs=pairs)
    log(f'# mgaf rotated_iou: {mrec["b1"]["ms"]:.4f} ms kernel for its '
        f'{mrec["b1"]["launches"]} launches, {mrec["b1"]["plain_ms"]:.3f} ms plain, '
        f'bound {mrec["b1"]["bound_ms"]:.6f} ms ({mrec["b1"]["bound_by"]}); '
        f'{live} of {pairs} pairs survive the cull')
    mrec['dcn'] = dcn_times(mgaf, batch)

    record.update(forward_stats(model, batch, 'fv2p'))
    mrec.update(forward_stats(mgaf, batch, 'mgaf'))
    mrec['dcn']['share_of_forward'] = mrec['dcn']['ms'] / mrec['forward_ms']['median']

    lap('kernel_and_forward_times')
    screc, sc_calls = sparse_conv_phase(model, meta)
    lap('sparse_conv')
    # 9b. training: fv2p.yaml in train mode at batch 2 on 24000-point scans,
    # bf16 compute and f32 parameters; the f32 step against the plain
    # versions, then the timed steps (each counted: B1, B2, B3 launch, B4
    # does not), then one more step whose kernel calls are held against
    # the plain versions and timed
    fv2p_launched = ('rotated_iou', 'fps', 'three_nn')
    train_batch, train_host_s, train_caps = train_inputs(cfg, meta, TRAIN_BATCH, TRAIN_POINTS)
    trec = {'batch': TRAIN_BATCH, 'points_cap': TRAIN_POINTS,
            'points_valid': train_batch['points_valid'].sum(1).tolist(),
            'gt_boxes': int((train_batch['gt_boxes'][..., 7] > 0).sum()),
            'batch_host_s': train_host_s, 'total_steps': TRAIN_TOTAL_STEPS,
            'level_caps': train_caps}
    log(f'# train batch: level capacities {train_caps} (the yaml\'s train caps)')
    trec['f32_kernel_vs_plain'] = train_f32_compare(kernels, cfg, meta, train_batch)
    step = make_train_step(cfg, meta, torch.bfloat16)
    trec.update(timed_train_steps(kcuda, step, train_batch, fv2p_launched, train_targets))
    tms = trec['ms']
    log(f'# train bf16 step at batch {TRAIN_BATCH}, ms median (quartiles) of '
        f'{TRAIN_TIMED}: ' + ', '.join(
            f'{k} {v["median"]:.2f} ({v["q1"]:.2f}-{v["q3"]:.2f})' for k, v in tms.items())
        + f'; peak device memory {trec["peak_mem_gib"]:.2f} GiB')
    passes = [module_times(step.model, lambda: step.step(train_batch),
                           tail='loss_backward_optimizer') for _ in range(MODULE_REPS)]
    trec['per_module_ms'] = {m: float(np.median([p[m] for p in passes])) for m in passes[0]}
    log(f'# train step per module (ms, median of {MODULE_REPS}; forward modules, then '
        f'loss + backward + optimizer): {trec["per_module_ms"]}')
    log(f'# train loss terms per step: {trec["loss_terms"]}')
    log(f'# train launches per step: {trec["launches_per_step"]}')
    log(f'# train first step targets: {trec["first_step_targets"]}')
    train_calls, trec['launches'] = captured_train_calls(kernels, step, train_batch,
                                                         fv2p_launched)
    train_kernel_rows(train_calls, trec['launches'], rows)
    del train_calls

    lap('fv2p_train')
    # 9b'. the runners on the KITTI fixture (data/kitti): eval_one_epoch over
    # the val scans at the test cap for FV2P and MGAF, the evaluator on the
    # val gt, and the train runner across a restart
    krec = {}
    (krec['eval'], kmodel, kfirst, kfirst_np, ktest_set, kannos,
     kret) = kitti_eval_phase(kernels, rows, cfg, 'kitti_eval',
                              ('rotated_iou', 'fps', 'three_nn', 'sa_group', 'sparse_conv'))
    krec['eval']['f32_kernel_vs_plain'] = kitti_eval_f32(kernels, cfg, ktest_set, kfirst,
                                                         kfirst_np)
    krec['mgaf_eval'], kmgaf, kmfirst, *_ = kitti_eval_phase(
        kernels, rows, mcfg, 'mgaf_kitti_eval', ('rotated_iou', 'sparse_conv', 'dcn'),
        calibrate=True)
    krec['evaluator'] = kitti_evaluator_phase(ktest_set, kannos, kret)
    krec['train'] = kitti_train_phase(kernels, rows, cfg)

    lap('kitti_runners')
    # 9c. MGAF training
    mtrec = mgaf_train_phase(kernels, mcfg, meta, rows)
    lap('mgaf_train')

    # 9d. device rulebooks: FV2P and MGAF on the bench batch as the loader
    # ships it with --rulebooks device, against host mode
    drec, build_rulebooks = device_rulebooks_phase(kernels, rows, cfg, mcfg, meta, batch_np,
                                                   model, mgaf, record, mrec)

    lap('device_rulebooks')
    # 9e. SECOND and PointPillar at full width on the bench scans, eval and
    # train (batch 4 each, with the six cars of each scan as gt)
    from fv2p_torch.utils.synthetic import synthetic_batch_np
    zoo_train_np = synthetic_batch_np(meta, BATCH, N_CAP, N_FILL, N_POINTS, seed=SEED + 2,
                                      gt='scan')
    zrec, later = {}, []
    for label, path in (('second', SECOND_CFG), ('pointpillar', PILLAR_CFG),
                        ('second_multihead', SECOND_MH_CFG)):
        zcfg = load_cfg(path)
        zrec[label] = zoo_phase(kernels, rows, label, zcfg,
                                *zoo_batches(zcfg, batch_np, zoo_train_np), later)

    lap('zoo')
    # 9e'. second.yaml with the ATSS assigner on `second`'s train batch,
    # then the demo on data/kitti's first val scan with kitti_train's
    # checkpoint, and its default invocation
    from fv2p_torch.tools import test as test_runner
    atss_rec = second_atss_phase(kernels, rows, zoo_batches(load_cfg(SECOND_CFG), batch_np,
                                                            zoo_train_np)[1])
    del zoo_train_np
    lap('second_atss')
    demo_ckpt = test_runner.checkpoint_list(REPO / 'output' / 'chip_smoke' / 'kitti_train'
                                            / 'ckpt')[-1][1]
    demo_rec = demo_phase(kernels, rows, demo_ckpt)
    lap('demo')
    # 9f. the runners with device rulebooks and SECOND on data/kitti
    krec['eval_device'] = kitti_eval_device_phase(kernels, rows, cfg, kmodel, krec['eval'],
                                                  kfirst, kfirst_np)
    krec['second'] = kitti_second_phase(kernels, rows)

    lap('kitti_device_and_second_runners')
    # 9g. the CBGS multihead models at full width on the nuScenes fixture,
    # eval and train, then the runners on it
    nrec = {label: nuscenes_phase(kernels, rows, label, path, later)
            for label, path in (('nuscenes', NUSC_SECOND_CFG), ('nuscenes_pp', NUSC_PP_CFG))}
    lap('nuscenes')
    nrec['runner'] = nuscenes_runner_phase(kernels, rows, later)
    lap('nuscenes_runner')

    # 9h. the RoI-grid models (PV-RCNN, Voxel R-CNN) at full width on the
    # bench scans, eval and train, then PV-RCNN through the runners on
    # data/kitti
    t0 = time.perf_counter()
    grid_eval, grid_train = grid_batches(meta, batch_np)
    grec = {'batches_s': time.perf_counter() - t0}
    for label in GRID_PATHS:
        t0 = time.perf_counter()
        grec[label] = grid_phase(kernels, rows, label, grid_eval, grid_train, later)
        grec[label]['phase_s'] = time.perf_counter() - t0
    del grid_eval, grid_train
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    grec['kitti_pv_rcnn'] = kitti_pv_rcnn_phase(kernels, rows)
    grec['kitti_pv_rcnn']['phase_s'] = time.perf_counter() - t0
    log(f'# RoI-grid phases (s): batches {grec["batches_s"]:.1f}, ' + ', '.join(
        f'{k} {grec[k]["phase_s"]:.1f}' for k in list(GRID_PATHS) + ['kitti_pv_rcnn']))
    lap('grid')

    # 9i. Waymo: FV2P (B2 on its 180000-point instantiation) and PV-RCNN at
    # full width on data/waymo, B2's corner cases at that size ran with the
    # others (8.); then the runners on the gate fixture and on data/waymo
    wrec = {'fv2p': waymo_fv2p_phase(kernels, rows, later)}
    lap('waymo_fv2p')
    wrec['pv_rcnn'] = waymo_pv_rcnn_phase(kernels, rows, later)
    lap('waymo_pv_rcnn')
    wrec['runner'] = waymo_runner_phase(kernels, rows)
    lap('waymo_runner')

    # 9j. PointRCNN on data/kitti at full width: eval, train steps and the
    # test runner
    prec = {'eval': kitti_pointrcnn_phase(kernels, rows, later)}
    lap('kitti_pointrcnn')
    prec['train'] = kitti_pointrcnn_train_phase(kernels, rows)
    lap('kitti_pointrcnn_train')
    # 9l. PartA2 on data/kitti at full width (eval, train steps, the three
    # KITTI yamls, the test runner, the runner's optimizers and profiler),
    # then on data/waymo
    parec = {'eval': kitti_parta2_phase(kernels, rows, later)}
    lap('kitti_parta2')
    parec['train'] = kitti_parta2_train_phase(kernels, rows)
    lap('kitti_parta2_train')
    parec['waymo'] = waymo_parta2_phase(kernels, rows, later)
    lap('waymo_parta2')
    # 9m. data parallel: torchrun at one rank against no --dist, two gloo
    # ranks on the card
    ddp_rec = ddp_phase()
    lap('ddp')

    # 10. under the profiler and the sync debug mode, after every timed pass
    record.update(profile_stats(model, batch, 'fv2p'))
    mrec.update(profile_stats(mgaf, batch, 'mgaf'))
    for key, m, first in (('eval', kmodel, kfirst), ('mgaf_eval', kmgaf, kmfirst)):
        prof = krec[key]['profile'] = profiled(lambda: forward(m, first))
        log(f'# {key} on data/kitti: device busy {prof["device_busy_ms"]:.2f} ms of a '
            f'profiled batch of {KITTI_BATCH} ({prof["wall_ms"]:.2f} ms, '
            f'{prof["busy_share"]:.1%})')
    trec['host_syncs'], trec['host_sync_sites'] = host_syncs(lambda: step.step(train_batch))
    trec['profile'] = profiled(lambda: step.step(train_batch))
    log(f'# train step: device busy {trec["profile"]["busy_share"]:.1%} of a profiled '
        f'step ({trec["profile"]["device_busy_ms"]:.2f} of {trec["profile"]["wall_ms"]:.2f} '
        f'ms); host waits {trec["host_syncs"]}; by line: {trec["host_sync_sites"]}')
    # each kernel's calls once more under the profiler: the card's own time
    for k, row in zip(kernels, rows):
        row['device_ms'] = device_ms(lambda: [k.launch(a) for a in k.calls],
                                     reps=2 if k.name == 'fps' else 5)
        if k.name == 'rotated_iou':
            row.update(iou_call_kernels(rotated_iou, k.calls))
            log(f'# rotated_iou: one IoU call queues {row["kernels_per_iou_call"]} '
                f'kernel(s), {row["kernels_per_composed_iou_call"]} when corners, '
                f'areas and division are tensor code around overlap_matrix')
        k.calls.clear()
    mrec['b1']['device_ms'] = device_ms(
        lambda: [mgaf_b1.launch(a) for a in mgaf_b1.calls], reps=5)
    from fv2p_torch.ops.cuda.sparse_conv import sparse_conv_fwd_cuda
    screc['device_ms'] = device_ms(lambda: [sparse_conv_fwd_cuda(*a) for a in sc_calls])
    del sc_calls
    # B1 at the cls-score models' call sites (SECOND, PointPillar, the
    # multihead models, the nuScenes test runner, PV-RCNN and Voxel R-CNN)
    # and B2 at PV-RCNN's
    row_of = {row['name']: row for row in rows}
    for label, k in later:
        row_of[k.name][f'{label}_device_ms'] = device_ms(
            lambda: [k.launch(a) for a in k.calls], reps=2 if k.name == 'fps' else 5)
    log('# device time (ms) at the later call sites: '
        f'{ {f"{k.name} {label}": round(row_of[k.name][f"{label}_device_ms"], 4) for label, k in later} }')
    with torch.no_grad():
        drec['builder_kernels'] = queued_kernels(build_rulebooks)
        drec['builder_device_ms'] = device_ms(build_rulebooks, reps=5)
    log(f'# device_rulebooks: the builder queues {drec["builder_kernels"]} kernels and '
        f'copies a forward, the card busy {drec["builder_device_ms"]:.3f} ms in them')
    log('# card busy in each kernel\'s calls of one forward (ms): '
        f'{ {row["name"]: round(row["device_ms"], 4) for row in rows} }; '
        f'B1 on MGAF\'s calls {mrec["b1"]["device_ms"]:.4f}')
    lap('profiler')
    record.update(launches=launches, kernels=rows, nvidia_smi=smi,
                  valid_detections=n_valid, mgaf=mrec, train=trec, mgaf_train=mtrec,
                  kitti=krec, device_rulebooks=drec, zoo=zrec, nuscenes=nrec, grid=grec,
                  waymo=wrec, pointrcnn=prec, parta2=parec, ddp=ddp_rec, phase_s=phase_s,
                  second_atss=atss_rec, demo=demo_rec, sparse_conv=screc,
                  wall_s=time.perf_counter() - T_START)
    log(f'# seconds by phase: { {k: round(v, 1) for k, v in phase_s.items()} }')
    log(f'# chip_smoke.py wall time {record["wall_s"]:.1f} s')

    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / 'chip_smoke.json').write_text(json.dumps(record, indent=1))
    log(json.dumps({'kernels': rows}))
    log(smi)
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
