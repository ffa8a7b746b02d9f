#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's RAFT inference path, its evaluation path,
its three train steps (Baseline, Unsup, flow-supervisor semi with and
without the teacher SMURF loss) through every kernel lookup, with and
without per-iteration remat, and data-parallel, its GMA and small models, its
training-data path through the train CLI, its entry points (the evaluate,
extract_flow and ckpt_tool CLIs over JPEG frames and a Sintel tree), and
the two kernels that no model path reaches (K5, K11) on one NVIDIA GPU.

    python3 chip_smoke.py

Prints the card's name and power limit (as nvidia-smi gives them), builds
the hand-written CUDA kernels of flow_supervisor_tpu_torch from the sources
in this checkout (one nvcc per source, in parallel) and its host I/O
library (g++), then runs its phases,
each printing one JSON line per check or configuration:

1. kernels: K1 (corr_plane), K2 (conv3x3 + stats), K3/K4 (instance norm),
   K5 (conv3x3, no statistics, relu on and off), K6/K7 (corr_fused, all
   levels / per level), K10 (corr_window: window mode, all levels, and
   support mode, one level), K8/K9 (the fused lookup's backward, bwd_df1 /
   bwd_df2) and K11 (corr_lookup, the 5-D volume's window) on the card
   against their plain PyTorch versions at the main paths' shapes and
   ragged ones, fp32 (TF32 off) and bf16, with lookup coords in bounds,
   partly out and far out of bounds; K1, K10 and K11 (one body,
   csrc/window.cuh) at radius 4 (compiled) and 3 (the radius an argument),
   K10's support mode bit-identical to the plain version; K1 also at radius 1,
   B=2, one level, and launched twice (bit-identical outputs); K6/K7,
   K8 and K9 also at smooth coords (the pixel grid plus N(0, 2 px), their
   tile path), B=1 and 2 (K7 and K8 also 8), C = 36, 256 and 320, and mixed
   with queries that send their tile to the per-query path, each case with
   its (level, tile) pairs by path; K8's bf16 results within one bf16 ulp
   of the plain fp32 value, and K8 launched twice (bit-identical outputs);
   K4 bit-identical to its plain version and K3 launched twice
   (bit-identical statistics) at the fnet shapes, ragged ones, C = 36 (the
   scalar body), B = 20 and M = 1, each on the body its rule picks;
2. parity: a 216x512, 12-iteration fp32 forward on the card (kernels) against
   the same model and weights on the CPU (plain versions), for each lookup
   backend (plane, fused, pallas, einsum, the zero ablation, and auto:
   fused on the card, einsum on the CPU);
3. main_path: for each configuration (lookup backend, batch) one 448x1024,
   12-iteration bf16 forward with the launch counters reset, which must
   launch each kernel the expected number of times (einsum B=1: the
   encoders' only, its lookup is plain PyTorch), run every K2 launch
   on the conv's tensor-core body and every K3 / K4 launch on the norm's
   vector body; then pairs/s over 20 back-to-back
   forwards, peak device memory, device time and idle share of one forward
   (torch.profiler), and the configuration's lookup
   kernel timed against its plain version on the inputs of the forward's
   last lookup, with its share of the bound (and the library call's, where
   there is one), K1 and K10 (fp32 outputs; K1 also bf16) checked bit for
   bit against their plain versions on those inputs; the encoder kernels
   K2-K4 are timed at B=1, and K3 / K4
   also at the fnet shapes of fused B=8 (16 images) and of the chairs
   Baseline step (20 images at 368x496). Kernel, plain
   and library times are device time (the timed calls queue behind a spin
   kernel); the forward's time is back to back, host included;
   own_paths: K5 and K11 through their own public functions
   (``conv3x3_fused``, ``corr_pyramid_lookup_pallas``), the JAX package's
   only callers, with the launch counters reset: K5 at the fnet stage shapes
   of a 448x1024 forward (10 calls), K11 on the 448x1024 volume pyramid at
   the coords of a forward's 12 lookups (12 launches); each timed against its
   plain version and a library call;
4. requests: ``run_pair`` on three Sintel-size pairs, writing and reading
   back ``.flo`` files;
   evaluate: the ``Evaluator`` over a Sintel tree (one scene, 4 frames at
   436x1024, clean and final, ``.flo`` labels) and a KITTI tree (2 pairs at
   375x1242, 16-bit flow PNGs, about 30 % valid) written by the port's own
   writers (each PNG read back and compared), on a full-width
   flow-supervisor RAFT with its teacher head (fp32, the auto lookup):
   Sintel at 32 iterations with warm start, then 12 teacher iterations;
   KITTI at 24 + 12 with pad_bucket 8 and 64. Each run must launch K6
   (iters + teacher iters) times a pair and K2 / K3 / K4 their encoder
   counts, and give every metric finite and in range; it prints pairs/s,
   host ms per pair (decode, warm start, forward), device ms and idle share
   of one pair (torch.profiler), peak memory and decode ms per frame. Then
   the same Evaluator on the card against the CPU at 216x512, 4 iterations,
   dense with warm start and sparse: |d EPE| < 1e-3 px, each n-px accuracy
   and Fl-all within 1e-2;
5. train_parity: one train step at fp32 on the card against the same step
   on the CPU (3 iterations, 64x96 crops of 96x128 frames), for each step
   kind: semi (Sintel recipe), Unsup (default loss, wang), semi with the
   teacher SMURF loss (brox, census 1, smooth2 2) and Baseline (B=2, unfrozen
   batch norm, whose running statistics are compared too): losses, merged
   gradients and updated parameters, within the PARITY_* limits;
6. train_main: the recipes' steps through ``training.loop.train`` at full
   width for two steps with the launch counters reset, which must launch
   each kernel the expected number of times; then steps/s over five steps by
   CUDA events, peak memory, device time and idle share of one step
   (torch.profiler): the Sintel semi step (B=1, 400x720 and 368x768 crops
   of 432x1024 frames, 12 + 12 iterations, bf16; K8/K9 timed against their
   plain versions on its lookup inputs), the KITTI semi step with the
   teacher SMURF loss (360x640 and 288x640 crops of 368x1240 frames), the
   Unsup step (368x768 crops of 432x1024 frames) and the chairs Baseline step
   (B=10, 368x496, unfrozen batch norm; K8/K9 timed at its shape too); every
   K2 launch of a step must run the conv's tensor-core body. Beside K8's and
   K9's times, the share of their (level, tile) pairs that took the tile
   path; every K3 / K4 launch of a step must run the norm's vector body;
   train_rest (run after train_main): K12 (corr_plane_bwd, the plane and
   pallas lookups' backward) against its plain version at the recipe's
   lookup grids (50x90, 46x96, 54x128) and the main path's 56x128, radius 4
   and 3, fp32 and bf16 cotangents and planes (the plain bits; fp32 within
   1e-5 of the largest |d_plane|, bf16 within one ulp of the fp32 value);
   one fp32 semi step through plane and through pallas on the card against
   the CPU at phase 5's limits; the Sintel semi recipe's step through plane
   and pallas as in train_main (K1 or K10 72 and K12 36 times a step), beside
   train_main's fused one,
   K12 timed on its lookups against its plain version and the library's
   ``grid_sampler_2d_backward``; the fused step with and without
   per-iteration remat (step ms, peak memory; one fp32 step's gradients
   with remat against those without at phase 5's limits); data parallelism
   (``parallel.dryrun``): a world of 1 over NCCL equal to the one-process
   step bit for bit, a world of 2 over gloo on the one card (semi with the
   teacher SMURF loss, Unsup, chairs Baseline with unfrozen batch norm)
   within ``dryrun.LIMITS``, and the chairs Baseline's world of 2 with
   cuDNN's convs (the one-card training path) within its cuDNN limit;
7. gma_small: the GMA model (the DAVIS recipe's: one head, content
   similarity) and the small model (4 levels at radius 3, bilinear
   upsampling), every GMA aggregator's gamma at 0.5 in the checks and
   forwards (it starts at zero, which leaves the attention out). K6 / K7, K8
   and K9 at radius 3 against their plain versions (smooth coords on the
   tile path, uniform ones mostly per query, mixed ones both in one launch;
   C = 128, the small model's, and 36; fp32 and bf16); card-vs-CPU fp32
   parity of each model's 216x512, 12-iteration forward under fused and
   plane (GMA also at 2 heads with the position and content similarity) at
   phase 2's limits; each model's 448x1024 B=1 bf16 forward under fused and
   plane with its launch counts (GMA: RAFT's; small: 21 K3 and K4, no K2,
   12 lookups at radius 3), fwd ms, peak memory, device time, idle share,
   and GMA's attention map and aggregation in device ms; the GMA recipe's
   semi step (train.sh:47-53: 368x768 crops of 432x856 frames, 12 + 12
   iterations) and the small model's chairs Baseline step (B=10, 368x496)
   through ``training.loop.train`` with their launch counts, and K8 / K9
   timed at radius 3 on the small step's lookup inputs; the train CLI for
   gma-semi (stage semi-davis_unsup-ctskh) on a tiny synthetic tree (its
   DAVIS frames baseline JPEG), 2 steps with validation, then a resume to 3;
   entry (run after gma_small): the CLIs on a gma-semi checkpoint directory
   (args.yaml, ckpt_1.pt; gamma 0.5, fp32, the auto lookup): extract_flow
   over a DAVIS directory of three 480x854 .jpg frames written by the port's
   encoder at quality 90, 12 iterations, with the launch counters reset (K6
   12 times a pair, K2-K4 their encoder counts), two .flo files and two vis
   PNGs, the first flow equal to ``Evaluator.predict`` on the same decoded
   frames, host ms a pair by decode, forward and write, device ms and idle
   share of a pair; evaluate on a 436x1024 Sintel tree (2 pairs a pass) at
   12 + 12 iterations with the counters reset, equal to the ``Evaluator`` in
   this process within 1e-6, device ms and idle share of a pair; ckpt_tool
   list and clean, and the cleaned directory evaluates to the same numbers;
   each frame's JPEG round trip (PSNR at least 38 dB) and decode ms a frame
   (host clock);
8. train_data: a dataset tree at the recipes' sizes written by the port's
   ``data/synthetic.py`` (Sintel 436x1024 training with flows and test,
   clean and final, 3 frames a scene; FlyingThings 540x960 with .pfm flows;
   FlyingChairs 384x512, 10 training pairs and 1 validation pair), then the
   train CLI (``python -m flow_supervisor_tpu_torch.train``) in this process
   with the launch counters reset before each run: the chairs Baseline stage
   (train.sh:4-6, B=10) for 2 steps, which saves a checkpoint; the Sintel
   semi recipe (train.sh:13-20) from it by --pretrained_ckpt, 6 steps,
   checkpoints at 3 and 6, standing validation (one record a set) at 0, 3
   and 6, 4 loader workers; the same command to 8 steps, which must resume
   at 6 with the optimizer count 6. Each run must launch the kernels of its
   step at least its steps' count, write its metrics rows with finite
   losses and its checkpoints. Then for the semi recipe: the loader alone
   (``fetch_dataloader``, batches/s over 10 batches after 2, with 0 and 4
   workers), steps/s of the composed step (the loader's next batch, then
   the step; 4 workers and serial) against in-memory batches (host clock)
   beside train_main's in-memory rate, and the device idle share of
   composed steps.

Then it prints K2's and K5's device time per fnet stage shape beside
``F.conv2d``'s, a JSON line of the kernels (launches in their configuration's
main-path run, max error, kernel, plain and library ms per forward (K8/K9:
per train step; K12: per plane-lookup semi step; K5: per forward's fnet stage
convs; K11: per 12 lookups),
and the least time the card could take for the same work; K1 and K6-K9
also their launches at radius 3 in phase 7's main-path runs, their largest
bf16 error there, and K8 / K9 their ms per small Baseline step) and last
``{"ok": true, "device": {...}}``. Any failure raises and the script exits
non-zero; so does a machine without a CUDA device. It imports nothing of JAX.
"""
import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

MAIN_HW = (448, 1024)
ITERS = 12
LEVELS = 4
RADIUS = 4
K2 = (2 * RADIUS + 1) ** 2
# the card's published rates (H100 SXM; dense, no sparsity): memory bytes/s,
# and operations/s by input type (bf16 on the tensor cores, fp32 outside)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}
# flops per lookup output: 4 tap products and 3 adds (weights not counted)
COMBINE_FLOPS = 7
# an upper bound of the SM clock (H100 SXM boosts to 1.98 GHz), to size the
# spin that keeps the device busy while the host enqueues timed calls
SPIN_CYCLES_PER_S = 2.0e9

SOURCES = {
    "corr_plane": ("flow_supervisor_tpu_torch/csrc/corr_plane.cu",
                   "flow_supervisor_tpu/kernels/corr_plane.py:271"),
    "conv3x3_stats": ("flow_supervisor_tpu_torch/csrc/conv3x3.cu",
                      "flow_supervisor_tpu/kernels/conv3x3.py:67"),
    "norm_stats": ("flow_supervisor_tpu_torch/csrc/norm.cu",
                   "flow_supervisor_tpu/kernels/norm.py:55"),
    "norm_apply": ("flow_supervisor_tpu_torch/csrc/norm.cu",
                   "flow_supervisor_tpu/kernels/norm.py:90"),
    "corr_fused_all": ("flow_supervisor_tpu_torch/csrc/corr_fused.cu",
                       "flow_supervisor_tpu/kernels/corr_fused.py:317"),
    "corr_fused_level": ("flow_supervisor_tpu_torch/csrc/corr_fused.cu",
                         "flow_supervisor_tpu/kernels/corr_fused.py:439"),
    "corr_window": ("flow_supervisor_tpu_torch/csrc/corr_window.cu",
                    "flow_supervisor_tpu/kernels/corr_lookup_v2.py:134"),
    "bwd_df1": ("flow_supervisor_tpu_torch/csrc/corr_fused_bwd.cu",
                "flow_supervisor_tpu/kernels/corr_fused.py:735"),
    "bwd_df2": ("flow_supervisor_tpu_torch/csrc/corr_fused_bwd.cu",
                "flow_supervisor_tpu/kernels/corr_fused.py:751"),
    "conv3x3_bare": ("flow_supervisor_tpu_torch/csrc/conv3x3.cu",
                     "flow_supervisor_tpu/kernels/conv3x3.py:59"),
    "corr_lookup_volume": ("flow_supervisor_tpu_torch/csrc/corr_lookup.cu",
                           "flow_supervisor_tpu/kernels/corr_lookup.py:40"),
    # K12 replaces no Pallas kernel: the XLA custom VJP of K1 (and of K10,
    # corr_lookup_v2.py:260), both through corr_fused.lookup_vjp_dvols
    "corr_plane_bwd": ("flow_supervisor_tpu_torch/csrc/corr_plane_bwd.cu",
                       "flow_supervisor_tpu/kernels/corr_plane.py:497"),
}
# the Sintel flow-supervisor recipe (train.sh): B=1, a 400x720 supervised and
# a 368x768 unsupervised crop of 432x1024 frames, 12 student and 12 teacher
# iterations, lr 1e-5 exponential, no weight decay, clipnorm 1
TRAIN_FULL, TRAIN_SUP, TRAIN_UNSUP = (432, 1024), (400, 720), (368, 768)
TRAIN_STEPS_MAIN, TRAIN_STEPS_TIMED = 2, 5  # the main path's steps (also warm-up), timed steps
RECIPE_MODEL = dict(model_type="raft-semi", iters=ITERS, teacher_iters=ITERS,
                    lfr_loss_type="robust", lfl_loss_decay_rate=1.0, lookup_backend="fused")
RECIPE_TRAIN = dict(stage="semi-sintel_unsup_test-things_unsup", lr=1e-5,
                    lr_schedule="exponential", lr_decay_steps=25000, weight_decay=0.0,
                    clip_norm=1.0, log_every=1)
# launches of each kernel in one semi step: fnet runs four times (the crop
# pair and the full pair, in each branch), 10 K2 + 5 K3 + 15 K4 each; every
# lookup is one K6 (sup: 12 student + 12 teacher; unsup: 2 directions x
# (12 + 12)); K8 and K9 run once per student lookup (sup 12, unsup 2 x 12):
# the teacher's pyramid carries no gradient
TRAIN_LAUNCHES = {"conv3x3_stats": 40, "norm_stats": 20, "norm_apply": 60,
                  "corr_fused_all": 72, "bwd_df1": 36, "bwd_df2": 36}
# K8 / K9 calls per step at each lookup shape: sup 50x90 (12), unsup 46x96 (24)
TRAIN_BWD_CALLS = {"sup": 12, "unsup": 24}
# the KITTI flow-supervisor recipe with the teacher SMURF loss (train.sh:25-34):
# B=1, 360x640 sup and 288x640 unsup crops of 368x1240 frames, 12 + 12
# iterations, lfl_loss_decay_rate 0.8, census 1, smooth1 0, smooth2 2, brox
KITTI_FULL, KITTI_SUP, KITTI_UNSUP = (368, 1240), (360, 640), (288, 640)
# the chairs Baseline stage (train.sh:4-6): B=10, 368x496, 12 iterations,
# lr 4e-4 onecycle, weight decay 1e-4, unfrozen batch norm
CHAIRS_HW, CHAIRS_BATCH = (368, 496), 10
# (ModelCfg, TrainCfg) fields of each step kind; the Unsup step runs the
# default loss (census 1, smooth1 2.5, selfsup 0.3, wang) with frozen batch
# norm at the Sintel shapes (368x768 crops of 432x1024 frames)
STEP_RECIPES = {
    "semi": (RECIPE_MODEL, RECIPE_TRAIN),
    "unsup": (dict(model_type="raft-unsup", iters=ITERS, lookup_backend="fused"),
              dict(RECIPE_TRAIN, stage="sintel_unsup", lr=1e-4)),
    "smurf": (dict(RECIPE_MODEL, lfl_loss_decay_rate=0.8, teacher_smurf_weight=1.0,
                   census_weight=1.0, smooth1_weight=0.0, smooth2_weight=2.0, occlusion="brox"),
              dict(RECIPE_TRAIN, stage="semi-kitti_unsup_test-things_unsup")),
    "baseline": (dict(model_type="raft-baseline", iters=ITERS, lookup_backend="fused"),
                 dict(stage="chairs", lr=4e-4, lr_schedule="onecycle", weight_decay=1e-4,
                      clip_norm=1.0, log_every=1)),
}
RECIPE_NAMES = {"semi": "semi sintel (train.sh)", "unsup": "unsup, sintel shapes, default loss",
                "smurf": "semi kitti with teacher SMURF (train.sh)",
                "baseline": "baseline chairs (train.sh)"}
# launches of each kernel per step. The KITTI semi step launches what the
# Sintel one does (the teacher SMURF loss adds no kernel; the teacher's
# pyramid still carries no gradient). Unsup: fnet twice (the teacher on the
# full frames, the student on the crops), 2 directions x 12 lookups each
# (K6), K8 / K9 for the student's 24. Baseline (B=10): fnet once, 12 lookups
# of one K7 per level, K8 / K9 for each lookup.
STEP_LAUNCHES = {
    "semi": TRAIN_LAUNCHES, "smurf": TRAIN_LAUNCHES,
    "unsup": {"conv3x3_stats": 20, "norm_stats": 10, "norm_apply": 30, "corr_fused_all": 48,
              "bwd_df1": 24, "bwd_df2": 24},
    "baseline": {"conv3x3_stats": 10, "norm_stats": 5, "norm_apply": 15,
                 "corr_fused_level": ITERS * LEVELS, "bwd_df1": ITERS, "bwd_df2": ITERS},
}
# phase 8, gma_small: the GMA model (the DAVIS recipe's, train.sh:47-53:
# gma-semi, one head, the content similarity) and the small model (4 levels at
# radius 3, bilinear upsampling). Every aggregator's gamma is set to
# GMA_GAMMA in the parity and forward runs (it starts at zero, which leaves
# the attention out of the result); the recipe steps start from the random
# init, as training does. The GMA step: B=1, 368x768 sup and unsup crops of
# 432x856 frames, 12 + 12 iterations, lfl_loss_decay_rate 0.8; the small
# model's: the chairs Baseline step (B=10, 368x496).
SMALL_RADIUS = 3
GMA_GAMMA = 0.5
GMA_FULL, GMA_CROP = (432, 856), (368, 768)
MODEL_KINDS = {"gma": dict(gma=True), "small": dict(small=True)}
MODEL_RECIPES = {
    "gma_semi": (dict(RECIPE_MODEL, model_type="gma-semi", lfl_loss_decay_rate=0.8),
                 dict(RECIPE_TRAIN, stage="semi-davis_unsup-ctskh")),
    "small_baseline": (dict(STEP_RECIPES["baseline"][0], small=True), STEP_RECIPES["baseline"][1]),
}
RECIPE_NAMES.update({"gma_semi": "gma semi davis (train.sh)",
                     "small_baseline": "small model, baseline chairs (train.sh shapes)"})
# the small model's fnet: the stem's norm and three in each of the six
# bottleneck blocks, two downsample norms: 21 instance norms (K3 + K4), no K2
SMALL_ENCODER_LAUNCHES = {"norm_stats": 21, "norm_apply": 21}
# the GMA semi step launches what the RAFT one does (the attention and the
# aggregation are torch.matmul); the small Baseline step (B=10): fnet once,
# 12 lookups of one K7 per level, K8 / K9 for each
STEP_LAUNCHES.update({
    "gma_semi": TRAIN_LAUNCHES,
    "small_baseline": {**SMALL_ENCODER_LAUNCHES, "corr_fused_level": ITERS * LEVELS,
                       "bwd_df1": ITERS, "bwd_df2": ITERS},
})
# K6-K9 at radius 3 (phase 8): smooth coords (the tile path), uniform ones
# (check_coords: most tiles per query) and mixed ones (both in one launch),
# at the small model's C = 128 and the scalar body's C = 36
R3_K6_K7_CASES = (("smooth", 1, 128), ("uniform", 1, 128), ("mixed", 2, 128), ("smooth", 8, 128),
                  ("smooth", 1, 36))
R3_BWD_CASES = (("smooth", 1, 128), ("uniform", 1, 128), ("mixed", 2, 128), ("smooth", 8, 128),
                ("smooth", 2, 36))
# phase 9, train_rest: the Sintel semi recipe (train.sh:13-20) through the
# plane and pallas lookups, whose backward is K12 (corr_plane_bwd). A step
# launches what the fused one does in the encoders, one K1 (plane) or K10
# (pallas) per lookup (72) and one K12 per student lookup (sup 12, unsup 2 x
# 12): the teacher's pyramid carries no gradient. The recipe's planes are
# fp32 (ModelCfg.corr_dtype): K1's cotangent arrives in bf16 (the lookup's
# output dtype), K10's in fp32.
MODEL_RECIPES.update({
    "semi_plane": (dict(RECIPE_MODEL, lookup_backend="plane"), RECIPE_TRAIN),
    "semi_pallas": (dict(RECIPE_MODEL, lookup_backend="pallas"), RECIPE_TRAIN),
})
RECIPE_NAMES.update({"semi_plane": "semi sintel (train.sh), plane lookup",
                     "semi_pallas": "semi sintel (train.sh), pallas lookup"})
_PLANE_STEP = {"conv3x3_stats": 40, "norm_stats": 20, "norm_apply": 60, "corr_plane_bwd": 36}
STEP_LAUNCHES.update({"semi_plane": {**_PLANE_STEP, "corr_plane": 72},
                      "semi_pallas": {**_PLANE_STEP, "corr_window": 72}})
# K12 against its plain version at the lookup grids of the recipe (the sup
# and unsup crops, the teacher's frame) and of the main path's 448x1024
K12_SHAPES = (("sup", (50, 90)), ("unsup", (46, 96)), ("teacher", (54, 128)),
              ("main", (MAIN_HW[0] // 8, MAIN_HW[1] // 8)))
# the train CLI on a tiny tree (48x64 frames): the GMA recipe's model type
# and stage at 32x48 crops of 40x56 frames, 12 + 12 iterations, bf16
GMA_CLI_FLAGS = ["--stage", "semi-davis_unsup-ctskh", "--model_type", "gma-semi",
                 "--image_size", "32", "48", "--unsup_image_size", "32", "48",
                 "--full_size", "40", "56", "--iters", "12", "--teacher_iters", "12",
                 "--batch_size", "1", "--lr", "1e-5", "--lr_schedule", "exponential",
                 "--lr_decay_steps", "25000", "--weight_decay", "0.0", "--lfr_loss_type", "robust",
                 "--lfl_loss_decay_rate", "0.8", "--val_step", "2", "--val_max_records", "1",
                 "--log_every", "1", "--loader_workers", "0"]
# the train_data phase: a dataset tree at the recipes' sizes (Sintel 436x1024
# frames, FlyingThings 540x960 with .pfm flows, FlyingChairs 384x512, 10
# training pairs and 1 validation pair; KITTI, HD1K and DAVIS at 48x64),
# written by the port's data/synthetic.py; the CLI runs the chairs Baseline
# stage (train.sh:4-6) and the Sintel semi recipe (train.sh:13-20) from it
TRAIN_DATA_SIZES = {"sintel": (436, 1024), "things": (540, 960), "chairs": (384, 512)}
TRAIN_DATA_CHAIRS_PAIRS = 11
CHAIRS_FLAGS = ["--stage", "chairs", "--iters", "12", "--image_size", "368", "496",
                "--val_step", "5000", "--lr", "4e-4", "--weight_decay", "1e-4", "--batch_size", "10"]
SEMI_FLAGS = ["--stage", "semi-sintel_unsup_test-things_unsup", "--model_type", "raft-semi",
              "--unsup_weight", "1.0", "--unsup_image_size", "368", "768", "--image_size", "400",
              "720", "--full_size", "432", "1024", "--iters", "12", "--lr", "1e-5",
              "--lr_schedule", "exponential", "--lr_decay_steps", "25000", "--weight_decay", "0.0",
              "--batch_size", "1", "--lfr_weight", "1.0", "--lfl_weight", "1.0",
              "--lfr_loss_type", "robust", "--lfl_loss_decay_rate", "1.0"]
CHAIRS_STEPS, SEMI_STEPS, SEMI_VAL_STEP, RESUME_STEPS = 2, 6, 3, 8
LOADER_WARM, LOADER_TIMED = 2, 10  # batches before timing, batches timed
COMPOSED_WARM, COMPOSED_TIMED, COMPOSED_PROFILED = 2, 5, 3  # steps
# Limits of the card-vs-CPU semi step (phase 5: fp32, 64x96 crops, 3 + 3
# iterations). The step is chaotic at fp32 rounding (ReLU kinks and bilinear
# taps through the loops): scaling every weight by 1 + 2^-24 * N(0, 1) moves
# some variables' gradients by up to about 1e-2 in relative L2, but fnet's,
# the ones K8/K9 reach, by about 2e-3; a K8 or K9 that drops one query's taps
# moves fnet's by about 1e-2. tests/test_torch_train_parity_limits.py
# measures both on the CPU and holds the limits between them. Adam's first
# step moves an element by at most lr, so two first steps differ by at most
# 2 lr; elements whose gradient is near eps scale turn fp32 noise into moves
# of up to that, so updates are held by their share within 1e-2 lr.
PARITY_ITERS = 3
PARITY_LOSS_REL = 1e-4
PARITY_GRAD_L2 = 3e-2  # per variable, ||g - g_ref|| / ||g_ref||
PARITY_FNET_GRAD_L2 = 4e-3  # the same, for fnet's variables
PARITY_NOISE_BIAS = 1e-4  # biases before instance norm, relative to their weight's gradient
PARITY_UPDATE_MAX_LR = 2.0 + 1e-3
PARITY_UPDATE_SHARE = 0.999
# the Unsup step's census loss has a gradient ill-conditioned in fp32 (the
# summation order alone moves it by about 2e-4 of its largest,
# tests/test_torch_train_unsup.py): a 2^-24 weight perturbation leaves only
# 99.4 % of its updates within 1e-2 lr (tests/test_torch_train_parity_steps.py),
# so its share is held at 99 %
PARITY_UPDATE_SHARE_BY_STEP = {"unsup": 0.99}
# Baseline's running batch-norm statistics: how far the step moved each, held
# relative to the CPU step's largest move. A 2^-24 weight perturbation moves
# them by about 7e-6, running_var moved toward the unbiased batch variance
# (nn.BatchNorm2d's rule) by 7.5e-3 (tests/test_torch_train_parity_steps.py)
PARITY_STATS_UPDATE_REL = 2e-4
# launches of each kernel in one 448x1024 forward, at any batch: fnet runs
# once over the 2B images, with 10 3x3 stride-1 conv -> instance-norm -> relu
# pairs (K2 + K4) and 5 other instance norms (stem, two stride-2 conv1s, two
# downsamples: K3 + K4); then 12 lookups, each one launch of K1 or K6, or one
# per level (4) of K7
ENCODER_LAUNCHES = {"conv3x3_stats": 10, "norm_stats": 5, "norm_apply": 15}
# (the einsum lookup is plain PyTorch: one-hot matrix products, no hand kernel)
LOOKUP_KERNEL = {("plane", 1): "corr_plane", ("fused", 1): "corr_fused_all",
                 ("fused", 8): "corr_fused_level", ("pallas", 1): "corr_window",
                 ("plane", 8): "corr_plane", ("einsum", 1): None}
LOOKUP_LAUNCHES = {"corr_plane": ITERS, "corr_fused_all": ITERS,
                   "corr_fused_level": ITERS * LEVELS, "corr_window": ITERS}
# (backend, batch) in the order they run; plane at B=8 is there for comparison,
# einsum at B=1 for the record (the auto rule never takes it on the card)
CONFIGS = [("plane", 1), ("fused", 1), ("fused", 8), ("pallas", 1), ("plane", 8), ("einsum", 1)]
# the evaluate phase (evaluate.py's defaults: fp32; 32 iterations for
# Sintel, 24 for KITTI; the recipes' 12 teacher iterations): the full frame
# sizes, the pairs, and the card-vs-CPU check's size, iterations and limits
EVAL_SINTEL_HW = (436, 1024)
EVAL_KITTI_HW = (375, 1242)
EVAL_SINTEL_FRAMES = 4
EVAL_KITTI_PAIRS = 2
EVAL_SINTEL_ITERS = 32
EVAL_KITTI_ITERS = 24
EVAL_TEACHER_ITERS = 12
EVAL_PARITY_HW = (216, 512)
EVAL_PARITY_ITERS = 4
EVAL_PARITY_EPE = 1e-3  # px, |card - CPU| of each mean EPE
EVAL_PARITY_SHARE = 1e-2  # of each n-px accuracy and Fl-all
# phase 2's backends; auto is fused on the card and einsum on the CPU
PARITY_BACKENDS = ("plane", "fused", "pallas", "einsum", "zero", "auto")
# the configuration whose main-path run gives each kernel's launches
# phase entry: the CLIs on a gma-semi checkpoint directory (fp32, auto: K6
# on the card), a DAVIS directory of 480x854 .jpg frames written by the
# port's encoder, and a Sintel tree at 436x1024 (2 pairs a pass)
ENTRY_DAVIS_HW = (480, 854)
ENTRY_FRAMES = 3
ENTRY_ITERS = 12
ENTRY_JPEG_QUALITY = 90
ENTRY_ROUND_TRIP_PSNR_DB = 38.0  # smooth frames at quality 90: 41.2 dB on the CPU
ENTRY_EXACT = 1e-6  # the CLIs against the same call in this process (px, metrics)
# The native readers against the numpy ones: files of each kind at its
# dataset's size (Sintel .flo, FlyingChairs .ppm, FlyingThings3D flow .pfm)
ENTRY_READ_FILES = 8
ENTRY_READ_THREADS = 4
HOME_CONFIG = {"corr_plane": ("plane", 1), "conv3x3_stats": ("plane", 1),
               "norm_stats": ("plane", 1), "norm_apply": ("plane", 1),
               "corr_fused_all": ("fused", 1), "corr_fused_level": ("fused", 8),
               "corr_window": ("pallas", 1), "bwd_df1": ("train", 1), "bwd_df2": ("train", 1),
               "conv3x3_bare": ("own", 1), "corr_lookup_volume": ("own", 1),
               "corr_plane_bwd": ("train_rest", 1)}
# fnet shapes at 448x1024 (B=1: the pair runs through fnet together) and how
# many times one forward runs each kernel there
CONV_SHAPES = [((2, 224, 512, 64), 64, 4), ((2, 112, 256, 96), 96, 3), ((2, 56, 128, 128), 128, 3)]
# the fnet's instance norms: (stride, C, K3 calls, K4 calls) per stage, the
# stem and layer1 at 1/2 (C = 64), layer2 at 1/4 (96), layer3 at 1/8 (128)
FNET_NORMS = ((2, 64, 1, 5), (4, 96, 2, 5), (8, 128, 2, 5))
# K3 / K4 are also timed at the fnet's norm shapes of the fused B=8 forward
# (16 images at 448x1024) and the chairs Baseline step (20 images at
# 368x496), where a forward or step runs them as often as at B=1
NORM_TIMING = {"fused_b8": (16, MAIN_HW), "chairs_b10": (2 * CHAIRS_BATCH, CHAIRS_HW)}
# phase 1's K3 / K4 shapes: the fnet's at B=1, M not a multiple of a block's
# rows (55x127, 37x50), C = 36 (the scalar body), the chairs batch's 20
# images (its stem 184x248 and layer3 46x62), M = 1
NORM_CHECK_SHAPES = [(2, MAIN_HW[0] // s, MAIN_HW[1] // s, c) for s, c, _, _ in FNET_NORMS] + [
    (1, 55, 127, 64), (2, 37, 50, 96), (2, 46, 62, 36), (20, 184, 248, 64), (20, 46, 62, 128),
    (3, 1, 1, 64), (2, 1, 1, 36)]


def fnet_norm_shapes(images: int, hw) -> list:
    """(shape, K3 calls, K4 calls) of the fnet's instance norms for `images`
    images of hw, per encoder call."""
    return [((images, hw[0] // s, hw[1] // s, c), n3, n4) for s, c, n3, n4 in FNET_NORMS]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def launch_counts() -> dict:
    from flow_supervisor_tpu_torch.kernels import (
        conv3x3, corr_fused, corr_lookup, corr_lookup_v2, corr_plane, norm,
    )

    return {"corr_plane": corr_plane.launches, "conv3x3_stats": conv3x3.launches,
            "norm_stats": norm.stats_launches, "norm_apply": norm.apply_launches,
            "corr_fused_all": corr_fused.all_launches,
            "corr_fused_level": corr_fused.level_launches,
            "corr_window": corr_lookup_v2.launches,
            "bwd_df1": corr_fused.bwd_df1_launches, "bwd_df2": corr_fused.bwd_df2_launches,
            "conv3x3_bare": conv3x3.bare_launches, "corr_lookup_volume": corr_lookup.launches,
            "corr_plane_bwd": corr_plane.bwd_launches}


def reset_launch_counts() -> None:
    from flow_supervisor_tpu_torch.kernels import (
        conv3x3, corr_fused, corr_lookup, corr_lookup_v2, corr_plane, norm,
    )

    corr_plane.launches = conv3x3.launches = norm.stats_launches = norm.apply_launches = 0
    norm.vector_launches = 0
    corr_fused.all_launches = corr_fused.level_launches = corr_lookup_v2.launches = 0
    corr_fused.bwd_df1_launches = corr_fused.bwd_df2_launches = 0
    conv3x3.bare_launches = corr_lookup.launches = conv3x3.tc_launches = 0
    corr_plane.bwd_launches = 0


def check_tc_launches(where: str, want: int) -> int:
    """Raises unless exactly `want` launches of K2 / K5 since the last reset
    ran the conv's tensor-core body (every bf16 conv of the model should)."""
    from flow_supervisor_tpu_torch.kernels import conv3x3

    if conv3x3.tc_launches != want:
        raise AssertionError(f"{where}: {conv3x3.tc_launches} conv launches on the tensor-core "
                             f"body, expected {want}")
    return conv3x3.tc_launches


def check_vector_launches(where: str, want: int) -> int:
    """Raises unless exactly `want` launches of K3 / K4 since the last reset
    ran the norm's vector body (every norm of the model should)."""
    from flow_supervisor_tpu_torch.kernels import norm

    if norm.vector_launches != want:
        raise AssertionError(f"{where}: {norm.vector_launches} norm launches on the vector "
                             f"body, expected {want}")
    return norm.vector_launches


def time_ms(fn, reps=20, warm=3, device_only=False) -> float:
    """Mean time of fn() in ms, by CUDA events around `reps` calls.

    device_only: the timed calls are queued behind a spin kernel that lasts
    twice as long as the host took to enqueue `reps` calls, so the events see
    the device's time alone; back to back, a small kernel would be timed at
    the host's launch rate instead."""
    import torch

    for _ in range(warm):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if device_only:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda._sleep(int(2 * host_s * SPIN_CYCLES_PER_S) + 1_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def ab_ms(kernel_fn, plain_fn, reps=20):
    """(kernel ms, plain ms) of device time, in turns plain, kernel, kernel, plain."""
    p1 = time_ms(plain_fn, reps, device_only=True)
    k1 = time_ms(kernel_fn, reps, device_only=True)
    k2 = time_ms(kernel_fn, reps, device_only=True)
    p2 = time_ms(plain_fn, reps, device_only=True)
    return (k1 + k2) / 2, (p1 + p2) / 2


def bound(nbytes: float, ops: float, dtype) -> tuple[float, float]:
    """(ms the card needs at least to move nbytes, ms for ops at the input type's peak)."""
    name = str(dtype).replace("torch.", "")
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS_PER_S[name] * 1e3


def check_close(name, got, want, rtol, atol):
    """Max |got - want|; raises if any element exceeds atol + rtol * |want|."""
    import torch

    got, want = got.float(), want.float()
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if not torch.isfinite(got).all() or bad.any():
        raise AssertionError(
            f"{name}: {int(bad.sum())} of {got.numel()} elements outside rtol={rtol} "
            f"atol={atol}; max abs err {float(err.max())}"
        )
    return float(err.max())


def check_ulp(name, got, want, atol):
    """Max |got - want| of a bf16 result against the plain fp32 value;
    raises unless every element is within 2^-8 * |want| of it (at least half
    a bf16 ulp of want and less than one: the bf16 rounding of an exact fp32
    sum is within half an ulp) plus atol for the fp32 sums' own error."""
    return check_close(name, got, want, 2.0 ** -8, atol)


def synthetic_pair(b, h, w, gen, shift=(3, 5)):
    """Smooth random image pair [B, H, W, 3] in [0, 1], the second shifted."""
    import torch
    import torch.nn.functional as F

    low = torch.rand(b, 3, h // 16 + 2, w // 16 + 2, generator=gen)
    img = F.interpolate(low, size=(h + 8, w + 8), mode="bilinear", align_corners=False)
    img1 = img[:, :, :h, :w]
    img2 = img[:, :, shift[0] : shift[0] + h, shift[1] : shift[1] + w]
    return (img1.permute(0, 2, 3, 1).contiguous(), img2.permute(0, 2, 3, 1).contiguous())


def check_coords(bq, h8, w8, gen, dev):
    """[BQ, 2] coords with windows in, partly in and fully out of bounds, and
    a few far out of bounds (up to 3e38)."""
    import torch

    u = torch.rand(bq, 2, generator=gen)
    coords = torch.stack([u[:, 0] * (w8 + 40) - 20, u[:, 1] * (h8 + 40) - 20], 1)
    far = torch.tensor([[1e9, -1e9], [-3e38, 3e38], [5e5, 7.5], [-2.5, -4e6]])
    coords[: len(far)] = far
    return coords.to(dev).contiguous()


def fmaps(b, h8, w8, dtype, gen, dev):
    import torch

    f1 = torch.randn(b, h8, w8, 256, generator=gen).to(dev, dtype)
    f2 = torch.randn(b, h8, w8, 256, generator=gen).to(dev, dtype)
    return f1, f2


def support_taps(coords, shapes, radius=RADIUS) -> int:
    """Support taps inside the maps, over all queries and the given levels
    ((level, (h2, w2)) pairs): what a lookup at these coords has to read."""
    import torch

    sup = 2 * radius + 2
    total = 0
    for lvl, (h2, w2) in shapes:
        fl = torch.floor(coords.float() * (1.0 / 2.0 ** lvl))
        bx = torch.clamp(fl[:, 0] - radius, -sup, w2)
        by = torch.clamp(fl[:, 1] - radius, -sup, h2)
        nx = torch.clamp(torch.clamp(bx + sup, max=w2) - torch.clamp(bx, min=0), min=0)
        ny = torch.clamp(torch.clamp(by + sup, max=h2) - torch.clamp(by, min=0), min=0)
        total += int((nx * ny).sum())
    return total


def k1_checks(dev, checks):
    """K1 beyond the main-path shapes, against its plain version: radius 1, 3
    and 4 (1 and 3 run the body that takes the radius as an argument), B=1 at the
    main shape and B=2 at the ragged 55x127 one, one level and four, coords
    in, partly and far out of bounds, fp32 and bf16; each case launched twice,
    and the two outputs must be bit-identical."""
    import torch

    from flow_supervisor_tpu_torch.kernels import corr_plane
    from flow_supervisor_tpu_torch.kernels.corr_plane import build_plane_pyramid

    gen = torch.Generator().manual_seed(11)
    main8 = (MAIN_HW[0] // 8, MAIN_HW[1] // 8)
    for dtype in (torch.float32, torch.bfloat16):
        rtol = 1e-2 if dtype == torch.bfloat16 else 0.0
        for b, (h8, w8) in ((1, main8), (2, (55, 127))):
            f1, f2 = fmaps(b, h8, w8, dtype, gen, dev)
            coords = check_coords(b * h8 * w8, h8, w8, gen, dev)
            for levels in (1, LEVELS):
                planes = build_plane_pyramid(f1, f2, levels, dtype)
                for radius in (1, 3, RADIUS):
                    name = f"K1 B={b} {h8}x{w8} levels={levels} r={radius} {dtype}"
                    got = corr_plane.corr_lookup(planes, coords, radius, dtype)
                    want = corr_plane.corr_lookup_plain(planes, coords, radius, torch.float32)
                    e = check_close(name, got, want, rtol, 1e-5)
                    if not torch.equal(corr_plane.corr_lookup(planes, coords, radius, dtype), got):
                        raise AssertionError(f"{name}: two launches differ")
                    checks.append({"kernel": "corr_plane", "batch": b, "shape": [h8, w8],
                                   "levels": levels, "radius": radius, "dtype": str(dtype),
                                   "err": e, "bit_identical": True})


def smooth_coords(b, h8, w8, gen, dev, sigma=2.0):
    """[B*h8*w8, 2]: the pixel grid plus N(0, sigma px), as a lookup's coords
    are at a smooth flow."""
    import torch

    ys, xs = torch.meshgrid(torch.arange(h8), torch.arange(w8), indexing="ij")
    grid = torch.stack([xs, ys], -1).float().expand(b, h8, w8, 2).reshape(-1, 2)
    return (grid + sigma * torch.randn(grid.shape, generator=gen)).to(dev).contiguous()


def diverging_queries(b, h8, w8):
    """Six queries a sample, in rows 12 and 24 (of >= 50): moved by (20, 20)
    px their windows stay in the map, 20 px from the rest of their tile, so
    the tile's level-0 box (>= 37 x 37 taps at radius 4, 35 x 35 at 3)
    exceeds MAX_BOX_TAPS."""
    return [bi * h8 * w8 + qy * w8 + qx
            for bi in range(b) for qy in (12, 24) for qx in (10, 40, 60)]


def tile_paths(f1, f2s, coords, radius=RADIUS) -> dict:
    """The (level, tile) pairs of K6 / K7 and K9 by path (``lookup_tiles``):
    in all and per level, how many take the shared-memory tile path and how
    many go per query (a tile with no valid query takes neither), the tile
    path's share of the pairs with a valid query, and the rows (taps of C
    channels) that the tile path's boxes read or add against those that one
    read or add per query and valid tap (the first K6 / K7 and K9) would."""
    from flow_supervisor_tpu_torch.kernels import corr_fused

    tiles = corr_fused.lookup_tiles(f1, f2s, coords, radius)
    tile_by = [int(t.tile_path.sum()) for t in tiles]
    per_query_by = [int(((t.queries > 0) & ~t.tile_path).sum()) for t in tiles]
    tile, per_query = sum(tile_by), sum(per_query_by)
    box_rows = sum(int(((t.x1 - t.x0) * (t.y1 - t.y0))[t.tile_path].sum()) for t in tiles)
    return {"tile_path": tile, "per_query": per_query,
            "tile_path_share": tile / max(tile + per_query, 1),
            "box_rows": box_rows,
            "per_query_rows": support_taps(coords, [(lvl, f2.shape[1:3])
                                                    for lvl, f2 in enumerate(f2s)], radius),
            "tile_path_by_level": tile_by, "per_query_by_level": per_query_by,
            "tile_path_share_by_level": [t / max(t + p, 1) for t, p in zip(tile_by, per_query_by)]}


K6_K7_CASES = (("smooth", 1, 256), ("smooth", 2, 256), ("smooth", 8, 256), ("mixed", 1, 256),
                ("mixed", 2, 256), ("smooth", 1, 36), ("smooth", 2, 36), ("smooth", 1, 320),
                ("smooth", 2, 320))


def k6_k7_checks(dev, dtype, gen, checks, radius=RADIUS, cases=K6_K7_CASES):
    """K6 (B=1) and K7 (B>1) at the main 56x128 shape against their plain
    version, beside the uniform coords of phase 1: smooth coords (the pixel
    grid plus N(0, 2 px)), where every tile takes the tile path, at B = 1, 2
    and 8; mixed ones, in which some tiles hold a query far out (it leaves
    the box) or 20 px off (its tile's box exceeds MAX_BOX_TAPS: that tile
    goes per query), so both paths run in one launch, at B = 1 and 2; C = 36
    (the CUDA-core body with scalar loads) and C = 320 (two channel chunks),
    smooth, at B = 1 and 2. fp32: sums of C products in another order (rtol
    1e-5, atol 1e-5); bf16: within one bf16 ulp of the plain fp32 value.
    ``cases`` ((coords, B, C) triples) may also name "uniform" coords
    (``check_coords``: most tiles per query); ``radius`` is the lookup's.
    Returns each kernel's largest error."""
    import torch

    from flow_supervisor_tpu_torch.kernels import corr_fused

    rtol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    h8, w8 = MAIN_HW[0] // 8, MAIN_HW[1] // 8
    k2 = (2 * radius + 1) ** 2
    errs = {}
    for name, b, c in cases:
        f1 = torch.randn(b, h8, w8, c, generator=gen).to(dev, dtype)
        f2 = torch.randn(b, h8, w8, c, generator=gen).to(dev, dtype)
        pyr = corr_fused.build_fused_pyramid(f1, f2, LEVELS)
        coords = smooth_coords(b, h8, w8, gen, dev)
        if name == "mixed":
            coords[::997] = torch.tensor([1e9, -1e9], device=dev)
            coords[diverging_queries(b, h8, w8)] += torch.tensor([20.0, 20.0], device=dev)
        if name == "uniform":  # check_coords: most tiles' boxes beyond MAX_BOX_TAPS
            coords = check_coords(b * h8 * w8, h8, w8, gen, dev)
        paths = tile_paths(pyr.f1, pyr.f2s, coords, radius)
        kname = "K6" if b == 1 else "K7"
        if paths["tile_path"] == 0 or (name != "smooth") != (paths["per_query"] > 0):
            raise AssertionError(f"{kname} {name} B={b} C={c} r={radius}: unexpected paths {paths}")
        if b == 1:
            got = corr_fused.corr_fused_all(pyr.f1, pyr.f2s, coords, radius, dtype)
        else:  # NaN until written: a channel no launch writes fails the check
            got = torch.full((coords.shape[0], LEVELS * k2), float("nan"), device=dev, dtype=dtype)
            for lvl, f2l in enumerate(pyr.f2s):
                corr_fused.corr_fused_level(pyr.f1, f2l, lvl, coords, radius, got, (h8, w8))
        want = corr_fused.corr_fused_plain(pyr.f1, pyr.f2s, coords, radius, torch.float32)
        e = check_close(f"{kname} {name} B={b} C={c} r={radius} {dtype}", got, want, rtol, 1e-5)
        kernel = "corr_fused_all" if b == 1 else "corr_fused_level"
        errs[kernel] = max(errs.get(kernel, 0.0), e)
        checks.append({"kernel": kernel, "coords": name, "batch": b, "shape": [h8, w8],
                       "channels": c, "radius": radius, "dtype": str(dtype), "err": e,
                       "tile_path_by_level": paths["tile_path_by_level"],
                       "per_query_by_level": paths["per_query_by_level"]})
        del f1, f2, pyr, got, want
    return errs


K9_CASES = (("smooth", 1, 256), ("smooth", 2, 256), ("mixed", 2, 256), ("smooth", 1, 36),
            ("smooth", 1, 320))


def k9_checks(dev, dtype, gen, checks, radius=RADIUS, cases=K9_CASES):
    """K9 on the tile path, against its plain version: smooth coords at the
    supervised crop's 50x90 at B=1 and B=2 (ragged tiles, tiles of both
    samples); a mixed case in which some tiles hold a query far out (it
    leaves the box) or 20 px off (its box exceeds MAX_BOX_TAPS: that tile
    adds per query), so both paths run in one launch; C = 36 (the scalar
    path) and C = 320 (two channel chunks). Tolerances as in phase 1's K9.
    ``cases`` and ``radius`` as in ``k6_k7_checks``; returns the largest
    error."""
    import torch

    from flow_supervisor_tpu_torch.kernels import corr_fused

    rtol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    err = 0.0
    for name, b, c in cases:
        pyr, coords, paths, g = bwd_tile_case(name, b, c, dtype, gen, dev, radius=radius)
        got = corr_fused.bwd_df2(pyr.f1, pyr.f2s, coords, g, radius)
        want = corr_fused.bwd_df2_plain(pyr.f1.float(), [f.float() for f in pyr.f2s], coords, g,
                                        radius)
        e = max(check_close(f"K9 {name} B={b} C={c} r={radius} level {lvl} {dtype}", a, w, rtol,
                            1e-4)
                for lvl, (a, w) in enumerate(zip(got, want)))
        err = max(err, e)
        checks.append({"kernel": "bwd_df2", "coords": name, "batch": b, "shape": [50, 90],
                       "channels": c, "radius": radius, "dtype": str(dtype), "err": e,
                       "tile_path": paths["tile_path"], "per_query": paths["per_query"]})
    return err


def bwd_tile_case(name, b, c, dtype, gen, dev, h8=50, w8=90, radius=RADIUS):
    """(fused pyramid, coords, their (level, tile) pairs by path, g) of a K8
    / K9 check at the supervised crop's 50x90: random features of C
    channels, smooth coords, and for name "mixed" some queries far out (they
    leave their tile's box) and some 20 px off (their tile's level-0 box
    exceeds MAX_BOX_TAPS, so it goes per query), so both bodies run in one
    launch; "uniform" coords (``check_coords``) send most tiles per query.
    Raises unless those paths are as the name says."""
    import torch

    from flow_supervisor_tpu_torch.kernels import corr_fused

    f1 = torch.randn(b, h8, w8, c, generator=gen).to(dev, dtype)
    f2 = torch.randn(b, h8, w8, c, generator=gen).to(dev, dtype)
    pyr = corr_fused.build_fused_pyramid(f1, f2, LEVELS)
    coords = smooth_coords(b, h8, w8, gen, dev)
    if name == "mixed":
        coords[::997] = torch.tensor([1e9, -1e9], device=dev)
        coords[diverging_queries(b, h8, w8)] += torch.tensor([20.0, 20.0], device=dev)
    elif name == "uniform":
        coords = check_coords(b * h8 * w8, h8, w8, gen, dev)
    paths = tile_paths(pyr.f1, pyr.f2s, coords, radius)
    if paths["tile_path"] == 0 or (name != "smooth") != (paths["per_query"] > 0):
        raise AssertionError(f"{name} B={b} C={c} r={radius}: unexpected paths {paths}")
    g = torch.randn(b * h8 * w8, LEVELS * (2 * radius + 1) ** 2, generator=gen).to(dev, dtype)
    return pyr, coords, paths, g


K8_CASES = (("smooth", 1, 256), ("smooth", 2, 256), ("smooth", 8, 256), ("mixed", 1, 256),
            ("mixed", 8, 256), ("smooth", 1, 36), ("smooth", 2, 36), ("smooth", 1, 320),
            ("smooth", 8, 320))


def k8_checks(dev, dtype, gen, checks, radius=RADIUS, cases=K8_CASES):
    """K8 on the tile path, against its plain version: smooth coords at the
    supervised crop's 50x90 at B=1 and 2 (84 and 168 blocks, fewer than two
    an SM) and B=8 (672); mixed cases in which some tiles hold a query far
    out (it leaves the box) or 20 px off (its level-0 box exceeds
    MAX_BOX_TAPS: that tile goes per query at that level), so both bodies run
    in one launch; C = 36 (the CUDA-core body with scalar loads) and C = 320
    (a ragged second channel slice). Each case runs twice and the two d_f1
    must be bitwise equal (no atomics, a fixed order of sums). fp32: sums of
    up to 400 products in another order (rtol 1e-5, atol 1e-4); bf16: one
    bf16 ulp of the plain fp32 value (``check_ulp``), atol 1e-4. ``cases``
    and ``radius`` as in ``k6_k7_checks``; returns the largest error."""
    import torch

    from flow_supervisor_tpu_torch.kernels import corr_fused

    err = 0.0
    for name, b, c in cases:
        pyr, coords, paths, g = bwd_tile_case(name, b, c, dtype, gen, dev, radius=radius)
        got = corr_fused.bwd_df1(pyr.f1, pyr.f2s, coords, g, radius)
        want = corr_fused.bwd_df1_plain(pyr.f1.float(), [f.float() for f in pyr.f2s], coords, g,
                                        radius)
        case = f"K8 {name} B={b} C={c} r={radius} {dtype}"
        e = (check_ulp(case, got, want, 1e-4) if dtype == torch.bfloat16
             else check_close(case, got, want, 1e-5, 1e-4))
        if not torch.equal(corr_fused.bwd_df1(pyr.f1, pyr.f2s, coords, g, radius), got):
            raise AssertionError(f"{case}: two launches differ")
        err = max(err, e)
        checks.append({"kernel": "bwd_df1", "coords": name, "batch": b, "shape": [50, 90],
                       "channels": c, "radius": radius, "dtype": str(dtype), "err": e,
                       "bit_identical": True, "tile_path_by_level": paths["tile_path_by_level"],
                       "per_query_by_level": paths["per_query_by_level"]})
        del pyr, got, want
    return err


def phase_kernels(dev):
    import torch

    from flow_supervisor_tpu_torch.kernels import (
        conv3x3, corr_fused, corr_lookup, corr_lookup_v2, corr_plane, norm,
    )
    from flow_supervisor_tpu_torch.kernels.corr_plane import build_plane_pyramid
    from flow_supervisor_tpu_torch.ops.corr import build_corr_pyramid_from_fmaps, window_support

    gen = torch.Generator().manual_seed(1)
    errs, checks = {k: 0.0 for k in SOURCES}, []
    k1_checks(dev, checks)
    main8 = (MAIN_HW[0] // 8, MAIN_HW[1] // 8)
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        # bf16: within 1 bf16 ulp of the plain fp32-accumulated value
        rtol = 1e-2 if bf16 else 0.0
        # lookups: main shape (BQ = 7168) and a ragged one (55 * 127 = 6985)
        for h8, w8 in (main8, (55, 127)):
            main = (h8, w8) == main8
            f1, f2 = fmaps(1, h8, w8, dtype, gen, dev)
            coords = check_coords(h8 * w8, h8, w8, gen, dev)
            planes = build_plane_pyramid(f1, f2, LEVELS, dtype)
            got = corr_plane.corr_lookup(planes, coords, RADIUS, dtype)
            want = corr_plane.corr_lookup_plain(planes, coords, RADIUS, torch.float32)
            e = check_close(f"K1 {h8}x{w8} {dtype}", got, want, rtol, 1e-5)
            checks.append({"kernel": "corr_plane", "shape": [h8, w8], "dtype": str(dtype), "err": e})
            if bf16 and main:
                errs["corr_plane"] = e
            # K10, window mode (all levels, fp32 out): the plain support,
            # combine (same order and rounding) and concat, atol 1e-6;
            # support mode (one level): a copy of plane values, the plain bits
            for radius in (RADIUS, 3):
                c4 = coords.reshape(1, h8, w8, 2)
                got = corr_lookup_v2.corr_pyramid_lookup_v2(planes, c4, radius)
                got = got.reshape(h8 * w8, -1)
                want = corr_plane.corr_lookup_plain(planes, coords, radius, torch.float32)
                case = f"K10 window r={radius} {h8}x{w8} {dtype}"
                e = check_close(case, got, want, 0.0, 1e-6)
                if not torch.equal(corr_lookup_v2.corr_pyramid_lookup_v2(planes, c4, radius)
                                   .reshape(h8 * w8, -1), got):
                    raise AssertionError(f"{case}: two launches differ")
                checks.append({"kernel": "corr_window", "mode": "window", "radius": radius,
                               "shape": [h8, w8], "dtype": str(dtype), "err": e,
                               "plain_bits": bool(torch.equal(got, want)), "bit_identical": True})
                if bf16 and main and radius == RADIUS:
                    errs["corr_window"] = e
                for lvl, plane in enumerate(planes):
                    cl = (coords * (1.0 / 2 ** lvl)).contiguous()
                    got = corr_lookup_v2.level_support(plane, cl, radius)
                    if not torch.equal(got, window_support(plane, cl, radius)):
                        raise AssertionError(f"K10 support r={radius} {h8}x{w8} level {lvl} "
                                             f"{dtype}: not the plain version's bits")
                    checks.append({"kernel": "corr_window", "mode": "support", "radius": radius,
                                   "shape": [h8, w8], "level": lvl, "dtype": str(dtype),
                                   "err": 0.0, "plain_bits": True})
            del got, want
            del planes
            # K6: fp32 sums of 256 products in another order (rtol 1e-5 for fp32)
            pyr = corr_fused.build_fused_pyramid(f1, f2, LEVELS)
            got = corr_fused.corr_fused_all(pyr.f1, pyr.f2s, coords, RADIUS, dtype)
            want = corr_fused.corr_fused_plain(pyr.f1, pyr.f2s, coords, RADIUS, torch.float32)
            e = check_close(f"K6 {h8}x{w8} {dtype}", got, want, rtol or 1e-5, 1e-5)
            paths = tile_paths(pyr.f1, pyr.f2s, coords)
            checks.append({"kernel": "corr_fused_all", "coords": "uniform", "shape": [h8, w8],
                           "dtype": str(dtype), "err": e,
                           "tile_path_by_level": paths["tile_path_by_level"],
                           "per_query_by_level": paths["per_query_by_level"]})
            if bf16 and main:
                errs["corr_fused_all"] = e
        # K7: B=1 and B=8 at the main shape, B=8 at the ragged one
        for b, (h8, w8) in ((1, main8), (8, main8), (8, (55, 127))):
            f1, f2 = fmaps(b, h8, w8, dtype, gen, dev)
            coords = check_coords(b * h8 * w8, h8, w8, gen, dev)
            pyr = corr_fused.build_fused_pyramid(f1, f2, LEVELS)
            got = torch.full((coords.shape[0], LEVELS * K2), float("nan"), device=dev, dtype=dtype)
            for lvl, f2l in enumerate(pyr.f2s):
                corr_fused.corr_fused_level(pyr.f1, f2l, lvl, coords, RADIUS, got, (h8, w8))
            want = corr_fused.corr_fused_plain(pyr.f1, pyr.f2s, coords, RADIUS, torch.float32)
            e = check_close(f"K7 B={b} {h8}x{w8} {dtype}", got, want, rtol or 1e-5, 1e-5)
            paths = tile_paths(pyr.f1, pyr.f2s, coords)
            checks.append({"kernel": "corr_fused_level", "coords": "uniform", "batch": b,
                           "shape": [h8, w8], "dtype": str(dtype), "err": e,
                           "tile_path_by_level": paths["tile_path_by_level"],
                           "per_query_by_level": paths["per_query_by_level"]})
            if bf16 and b == 8 and (h8, w8) == main8:
                errs["corr_fused_level"] = e
        k6_k7_checks(dev, dtype, gen, checks)
        # K8 / K9 at the recipe's student level-0 shapes: 50x90 (400x720 crop)
        # at B=1 and B=2 (4,500 queries a sample: blocks straddle samples) and
        # 46x96 (368x768). fp32: sums of up to 400 (K8) and several thousand
        # (K9 at level 3, in an order the atomics change) products in another
        # order, rtol 1e-5 atol 1e-4; bf16: within 1 bf16 ulp of plain fp32
        for b, (h8, w8) in ((1, (50, 90)), (2, (50, 90)), (1, (46, 96))):
            f1, f2 = fmaps(b, h8, w8, dtype, gen, dev)
            coords = check_coords(b * h8 * w8, h8, w8, gen, dev)
            pyr = corr_fused.build_fused_pyramid(f1, f2, LEVELS)
            g = torch.randn(b * h8 * w8, LEVELS * K2, generator=gen).to(dev, dtype)
            f1p, f2p = pyr.f1.float(), [f.float() for f in pyr.f2s]
            got = corr_fused.bwd_df1(pyr.f1, pyr.f2s, coords, g, RADIUS)
            want = corr_fused.bwd_df1_plain(f1p, f2p, coords, g, RADIUS)
            e8 = check_close(f"K8 B={b} {h8}x{w8} {dtype}", got, want, rtol or 1e-5, 1e-4)
            got = corr_fused.bwd_df2(pyr.f1, pyr.f2s, coords, g, RADIUS)
            want = corr_fused.bwd_df2_plain(f1p, f2p, coords, g, RADIUS)
            e9 = max(check_close(f"K9 B={b} {h8}x{w8} level {lvl} {dtype}", a, w, rtol or 1e-5, 1e-4)
                     for lvl, (a, w) in enumerate(zip(got, want)))
            checks.append({"kernel": "bwd_df1", "batch": b, "shape": [h8, w8], "dtype": str(dtype),
                           "err": e8})
            checks.append({"kernel": "bwd_df2", "batch": b, "shape": [h8, w8], "dtype": str(dtype),
                           "err": e9})
            if bf16 and (b, h8) == (1, 50):
                errs["bwd_df1"], errs["bwd_df2"] = e8, e9
            del pyr, got, want, f1p, f2p
        k8_checks(dev, dtype, gen, checks)
        k9_checks(dev, dtype, gen, checks)
        # K2: the three stage shapes, a width that is not a multiple of 8 and
        # the KITTI fnet width (155) at C = 96, Cout = 72; bf16 on the
        # tensor-core body, fp32 on the CUDA cores
        for shape, cout, n in CONV_SHAPES + [((2, 55, 90, 128), 128, 0), ((2, 46, 155, 96), 72, 0)]:
            c = shape[3]
            x = torch.randn(*shape, generator=gen).to(dev, dtype)
            w = (torch.randn(3, 3, c, cout, generator=gen) * (2.0 / (9 * cout)) ** 0.5).to(dev, dtype)
            b = (0.1 * torch.randn(cout, generator=gen)).to(dev, dtype)
            tc0 = conv3x3.tc_launches
            y, st = conv3x3.conv3x3_stats(x, w, b)
            if conv3x3.tc_launches - tc0 != int(bf16):
                raise AssertionError(f"K2 {shape} {dtype}: tensor-core launches {conv3x3.tc_launches - tc0}")
            y_ref, st_ref = conv3x3.conv3x3_stats_plain(x, w, b)
            # fp32: only the summation order of 9*C <= 1152 terms differs
            e = check_close(f"K2 y {shape} {dtype}", y, y_ref, 1e-2 if bf16 else 1e-4, 1e-5)
            es = check_close(f"K2 stats {shape} {dtype}", st, st_ref, 1e-4, 1e-5)
            checks.append({"kernel": "conv3x3_stats", "shape": list(shape), "cout": cout,
                           "dtype": str(dtype), "err": e, "stats_err": es, "tensor_cores": bf16})
            if bf16 and n:
                errs["conv3x3_stats"] = max(errs["conv3x3_stats"], e)
        # K3 / K4, relu on and off: K4 has the plain version's arithmetic, so
        # its bits; K3's fp32 sums run in another order (atol 1e-5), in a fixed
        # one, so a second launch gives the same bits
        for shape in NORM_CHECK_SHAPES:
            x = (3 * torch.randn(*shape, generator=gen) + 1.5).to(dev, dtype)
            vec, vec0 = norm.vector_body(x), norm.vector_launches
            st = norm.instance_norm_stats(x)
            st_ref = norm.instance_norm_stats_plain(x)
            e = check_close(f"K3 {shape} {dtype}", st, st_ref, 0.0, 1e-5)
            if not torch.equal(norm.instance_norm_stats(x), st):
                raise AssertionError(f"K3 {shape} {dtype}: a second launch gave other bits")
            checks.append({"kernel": "norm_stats", "shape": list(shape), "dtype": str(dtype),
                           "err": e, "vector_body": vec, "same_bits_twice": True})
            for relu in (False, True):
                y = norm.instance_norm_apply(x, st_ref, relu)
                y_ref = norm.instance_norm_apply_plain(x, st_ref, relu)
                ea = float((y.float() - y_ref.float()).abs().max())
                if not torch.equal(y, y_ref):
                    raise AssertionError(f"K4 {shape} relu={relu} {dtype}: not the plain "
                                         f"version's bits, max abs err {ea}")
                checks.append({"kernel": "norm_apply", "shape": list(shape), "dtype": str(dtype),
                               "relu": relu, "err": ea, "vector_body": vec, "plain_bits": True})
                if bf16:
                    errs["norm_apply"] = max(errs["norm_apply"], ea)
            if norm.vector_launches - vec0 != 4 * vec:
                raise AssertionError(f"K3/K4 {shape} {dtype}: {norm.vector_launches - vec0} "
                                     f"vector-body launches of 4, vector_body {vec}")
            if bf16:
                errs["norm_stats"] = max(errs["norm_stats"], e)
            del x, st, st_ref, y, y_ref
        # K5: the fnet stage shapes and a ragged one, relu off and on; fp32:
        # only the summation order of 9*C <= 1152 terms differs
        for shape, cout, n in CONV_SHAPES + [((2, 55, 90, 128), 72, 0), ((2, 46, 155, 96), 72, 0)]:
            c = shape[3]
            x = torch.randn(*shape, generator=gen).to(dev, dtype)
            w = (torch.randn(3, 3, c, cout, generator=gen) * (2.0 / (9 * cout)) ** 0.5).to(dev, dtype)
            b = (0.1 * torch.randn(cout, generator=gen)).to(dev, dtype)
            for relu in (False, True):
                tc0 = conv3x3.tc_launches
                got = conv3x3.conv3x3_bare(x, w, b, relu)
                if conv3x3.tc_launches - tc0 != int(bf16):
                    raise AssertionError(f"K5 {shape} {dtype}: tensor-core launches {conv3x3.tc_launches - tc0}")
                e = check_close(f"K5 {shape} relu={relu} {dtype}", got,
                                conv3x3.conv3x3_bare_plain(x, w, b, relu), 1e-2 if bf16 else 1e-4, 1e-5)
                checks.append({"kernel": "conv3x3_bare", "shape": list(shape), "cout": cout,
                               "relu": relu, "dtype": str(dtype), "err": e, "tensor_cores": bf16})
                if bf16 and n:
                    errs["conv3x3_bare"] = max(errs["conv3x3_bare"], e)
        # K11: volumes in dtype (read as fp32, fp32 out) at the ragged 55x127
        # and the 448x1024 shape (level 0: 7168 x 7168); the same bilinear
        # formula on the same values, so fp32 rounding only
        for h8, w8 in ((55, 127), main8):
            f1, f2 = fmaps(1, h8, w8, dtype, gen, dev)
            vols = build_corr_pyramid_from_fmaps(f1, f2, LEVELS, dtype)
            del f1, f2
            coords = check_coords(h8 * w8, h8, w8, gen, dev).reshape(1, h8, w8, 2)
            for radius in (RADIUS, 3):
                got = corr_lookup.corr_pyramid_lookup_pallas(vols, coords, radius)
                want = torch.cat([corr_lookup.lookup_level_plain(v, coords / 2.0 ** i, radius)
                                  for i, v in enumerate(vols)], -1)
                e = check_close(f"K11 r={radius} {h8}x{w8} {dtype}", got, want, 1e-5, 1e-5)
                checks.append({"kernel": "corr_lookup_volume", "radius": radius, "shape": [h8, w8],
                               "dtype": str(dtype), "err": e,
                               "plain_bits": bool(torch.equal(got, want))})
                if (h8, w8) == main8 and radius == RADIUS:
                    errs["corr_lookup_volume"] = max(errs["corr_lookup_volume"], e)
            del vols, got, want
    torch.cuda.synchronize()
    emit({"phase": "kernels", "ok": True, "checks": checks})
    return errs


def phase_parity(dev):
    import torch

    from flow_supervisor_tpu_torch.models.raft import RAFT, RAFTConfig

    from flow_supervisor_tpu_torch.models.raft import resolve_lookup_backend

    gen = torch.Generator().manual_seed(2)
    base = RAFT(RAFTConfig(iters=ITERS), generator=gen)
    img1, img2 = synthetic_pair(1, 216, 512, gen)
    for backend in PARITY_BACKENDS:
        model = RAFT(RAFTConfig(iters=ITERS, lookup_backend=backend))
        model.load_state_dict(base.state_dict())
        cpu = model(img1, img2, final_flow_only=True)["flow_up"][-1]
        model.to(dev)
        gpu = model(img1.to(dev), img2.to(dev), final_flow_only=True)["flow_up"][-1].cpu()
        d = (gpu - cpu).abs()
        res = {"phase": "parity", "lookup_backend": backend,
               "ran": {"gpu": resolve_lookup_backend(backend, dev),
                       "cpu": resolve_lookup_backend(backend, "cpu")},
               "hw": [216, 512], "iters": ITERS,
               "dtype": "float32", "mean_abs_diff_px": float(d.mean()),
               "max_abs_diff_px": float(d.max()), "max_abs_flow_px": float(cpu.abs().max())}
        res["ok"] = bool(torch.isfinite(gpu).all() and res["mean_abs_diff_px"] < 1e-3
                         and res["max_abs_diff_px"] < 2e-2)
        emit(res)
        if not res["ok"]:
            raise AssertionError(f"end-to-end parity failed: {res}")


def window_grids(shapes, coords, dev):
    """F.grid_sample grids [BQ, 2r+1, 2r+1, 2] of the windows at coords [BQ,
    2] / 2^level in planes of shapes [(h2, w2)], laid out so that a sample's
    output is dx-major (align_corners=True)."""
    import torch

    bq = coords.shape[0]
    d = torch.arange(-RADIUS, RADIUS + 1, device=dev, dtype=torch.float32)
    grids = []
    for lvl, (h2, w2) in enumerate(shapes):
        c = coords * (1.0 / 2 ** lvl)
        gx = (c[:, 0, None, None] + d[None, :, None]).expand(bq, 2 * RADIUS + 1, 2 * RADIUS + 1)
        gy = (c[:, 1, None, None] + d[None, None, :]).expand(bq, 2 * RADIUS + 1, 2 * RADIUS + 1)
        grids.append(torch.stack([2 * gx / max(w2 - 1, 1) - 1, 2 * gy / max(h2 - 1, 1) - 1], -1))
    return grids


def grid_sample_library(planes, coords, dev):
    """RAFT's own sampler as one library call per level: F.grid_sample over
    [BQ, 1, h2, w2] fp32 copies of the planes [BQ, h2, w2] (a bf16 grid cannot
    hold the coords) at coords [BQ, 2] / 2^level, the grid laid out so that
    the output is dx-major. Returns the calls as one function."""
    import torch.nn.functional as F

    grids = window_grids([tuple(p.shape[1:]) for p in planes], coords, dev)
    p32 = [plane.float()[:, None] for plane in planes]

    def library():
        return [F.grid_sample(pl, g, mode="bilinear", padding_mode="zeros", align_corners=True)
                for pl, g in zip(p32, grids)]

    return library


def lookup_timing(backend, batch, pyramid, coords, dev):
    """The configuration's lookup kernel against its plain version (and a
    library call where one computes the same function) on the inputs of the
    forward's last lookup: ms per forward, and the card's least time for it.
    K1 and K10 are also held bit for bit against their plain versions there
    (raises otherwise): fp32 outputs, and K1's bf16 one."""
    import torch

    from flow_supervisor_tpu_torch.kernels import corr_fused, corr_lookup_v2, corr_plane

    bf16 = torch.bfloat16
    bq = coords.shape[0]
    name = LOOKUP_KERNEL[(backend, batch)]
    out_bytes = bq * LEVELS * K2 * 2
    library_ms = None
    extra = {}
    if backend == "plane":
        planes = pyramid
        shapes = [(lvl, tuple(p.shape[1:])) for lvl, p in enumerate(planes)]
        extra["equals_plain_bits"] = {}
        for dtype in (bf16, torch.float32):
            if not torch.equal(corr_plane.corr_lookup(planes, coords, RADIUS, dtype),
                               corr_plane.corr_lookup_plain(planes, coords, RADIUS, dtype)):
                raise AssertionError(f"K1 {backend} B={batch} {dtype}: not the plain bits")
            extra["equals_plain_bits"][str(dtype)] = True
        k, p = ab_ms(lambda: corr_plane.corr_lookup(planes, coords, RADIUS, bf16),
                     lambda: corr_plane.corr_lookup_plain(planes, coords, RADIUS, bf16))
        nbytes = support_taps(coords, shapes) * 2 + coords.numel() * 4 + out_bytes
        ops = bq * LEVELS * K2 * COMBINE_FLOPS
        library = grid_sample_library(planes, coords, dev)
        lib_out = torch.cat([o.reshape(bq, K2) for o in library()], 1)
        library_err = float((lib_out - corr_plane.corr_lookup_plain(
            planes, coords, RADIUS, torch.float32)).abs().max())
        library_ms = time_ms(library, device_only=True) * ITERS
        del library, lib_out
        in_dtype = planes[0].dtype
    elif backend == "fused":
        f1, f2s = pyramid.f1, pyramid.f2s
        shapes = [(lvl, tuple(f2.shape[1:3])) for lvl, f2 in enumerate(f2s)]
        c = f1.shape[2]
        fixed = f1.numel() * f1.element_size() + coords.numel() * 4
        if batch == 1:
            k, p = ab_ms(lambda: corr_fused.corr_fused_all(f1, f2s, coords, RADIUS, bf16),
                         lambda: corr_fused.corr_fused_plain(f1, f2s, coords, RADIUS, bf16))
            nbytes = fixed + sum(f2.numel() * f2.element_size() for f2 in f2s) + out_bytes
        else:
            out = torch.empty((bq, LEVELS * K2), device=dev, dtype=bf16)

            def kernel():
                for lvl, f2 in enumerate(f2s):
                    corr_fused.corr_fused_level(f1, f2, lvl, coords, RADIUS, out, shapes[0][1])

            def plain():
                for lvl, f2 in enumerate(f2s):
                    out[:, lvl * K2 : (lvl + 1) * K2] = corr_fused.corr_fused_plain(
                        f1, [f2], coords, RADIUS, bf16, first_level=lvl)

            k, p = ab_ms(kernel, plain)
            # one launch per level: each reads f1 and the coords once
            nbytes = LEVELS * fixed + sum(f2.numel() * f2.element_size() for f2 in f2s) + out_bytes
        ops = 2 * c * support_taps(coords, shapes) + bq * LEVELS * K2 * COMBINE_FLOPS
        in_dtype = f1.dtype
        library_err = None
        extra["tile_paths"] = tile_paths(f1, f2s, coords)
    else:  # pallas
        planes = pyramid
        shapes = [(lvl, tuple(p.shape[1:])) for lvl, p in enumerate(planes)]
        c4 = coords.reshape(1, 1, bq, 2)
        got = corr_lookup_v2.corr_pyramid_lookup_v2(planes, c4, RADIUS).reshape(bq, -1)
        if not torch.equal(got, corr_plane.corr_lookup_plain(planes, coords, RADIUS)):
            raise AssertionError(f"K10 {backend} B={batch}: not the plain version's bits")
        extra["equals_plain_bits"] = {"torch.float32": True}
        k, p = ab_ms(lambda: corr_lookup_v2.corr_pyramid_lookup_v2(planes, c4, RADIUS),
                     lambda: corr_plane.corr_lookup_plain(planes, coords, RADIUS))
        # one launch: the support taps inside the planes (bf16), the coords
        # once, the fp32 window written once
        nbytes = support_taps(coords, shapes) * 2 + coords.numel() * 4 + bq * LEVELS * K2 * 4
        ops = bq * LEVELS * K2 * COMBINE_FLOPS
        library = grid_sample_library(planes, coords, dev)
        lib_out = torch.cat([o.reshape(bq, K2) for o in library()], 1)
        library_err = float((lib_out - got).abs().max())
        library_ms = time_ms(library, device_only=True) * ITERS
        del library, lib_out, got
        in_dtype = planes[0].dtype
    t_bytes, t_ops = bound(nbytes, ops, in_dtype)
    bound_ms = max(t_bytes, t_ops) * ITERS
    return name, {"ms": k * ITERS, "plain_ms": p * ITERS, "library_ms": library_ms,
                  "library_max_abs_err": library_err, "bound_ms": bound_ms,
                  "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                  "share_of_bound": bound_ms / (k * ITERS),
                  "library_share_of_bound": None if library_ms is None else bound_ms / library_ms,
                  "bytes_per_call": nbytes, "ops_per_call": ops, **extra}


def encoder_timing(dev, images=2, hw=MAIN_HW, conv=True):
    """K2-K4 (K3 / K4 alone without conv) against their plain versions and a
    library call, at the fnet shapes of `images` images of hw (a B=1 forward:
    2 at 448x1024), as ms per encoder call (per-call time x calls)."""
    import torch
    import torch.nn.functional as F

    from flow_supervisor_tpu_torch.kernels import conv3x3, norm

    gen = torch.Generator().manual_seed(5)
    bf16 = torch.bfloat16
    names = ("conv3x3_stats", "norm_stats", "norm_apply") if conv else ("norm_stats", "norm_apply")
    times = {n: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
                 "t_bytes": 0.0, "t_ops": 0.0, "per_call": []} for n in names}

    def add(name, n, k, p, lib, nbytes, ops, shape):
        t = times[name]
        tb, to = bound(nbytes, ops, bf16)
        t["ms"] += n * k
        t["plain_ms"] += n * p
        t["library_ms"] += n * lib
        t["bound_ms"] += n * max(tb, to)
        t["t_bytes"] += n * tb
        t["t_ops"] += n * to
        t["per_call"].append([list(shape), k, p, lib, max(tb, to)])

    for shape, cout, n in CONV_SHAPES if conv else ():
        bsz, h, w, c = shape
        x = torch.randn(*shape, generator=gen).to(dev, bf16)
        wt = (0.05 * torch.randn(3, 3, c, cout, generator=gen)).to(dev, bf16)
        b = torch.zeros(cout, device=dev, dtype=bf16)
        k, p = ab_ms(lambda: conv3x3.conv3x3_stats(x, wt, b),
                     lambda: conv3x3.conv3x3_stats_plain(x, wt, b))
        # cuDNN's bf16 conv alone (no statistics epilogue has a single call)
        xn = x.permute(0, 3, 1, 2)
        wn = wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        lib = time_ms(lambda: F.conv2d(xn, wn, b, padding=1), device_only=True)
        nbytes = 2 * (x.numel() + wt.numel() + cout + bsz * h * w * cout) + bsz * 2 * cout * 4
        add("conv3x3_stats", n, k, p, lib, nbytes, 2 * bsz * h * w * cout * 9 * c, shape)
    for shape, n_stats, n_apply in fnet_norm_shapes(images, hw):
        bsz, _, _, c = shape
        x = torch.randn(*shape, generator=gen).to(dev, bf16)
        st = norm.instance_norm_stats_plain(x)
        xn = x.permute(0, 3, 1, 2)
        k, p = ab_ms(lambda: norm.instance_norm_stats(x), lambda: norm.instance_norm_stats_plain(x))
        # the same statistics (mean and variance per sample and channel) in one call
        lib = time_ms(lambda: torch.var_mean(x, dim=(1, 2), correction=0), device_only=True)
        add("norm_stats", n_stats, k, p, lib, x.numel() * 2 + bsz * 2 * c * 4, 3 * x.numel(), shape)
        k, p = ab_ms(lambda: norm.instance_norm_apply(x, st, True),
                     lambda: norm.instance_norm_apply_plain(x, st, True))
        # no call applies given statistics: the whole norm (statistics and apply)
        lib = time_ms(lambda: F.instance_norm(xn), device_only=True)
        add("norm_apply", n_apply, k, p, lib, 2 * x.numel() * 2 + bsz * 2 * c * 4, 3 * x.numel(), shape)
        del x, xn, st
    for t in times.values():
        t["bound_by"] = "bytes" if t.pop("t_bytes") >= t.pop("t_ops") else "operations"
    torch.cuda.empty_cache()
    return times


def phase_main_path(dev):
    import torch

    from flow_supervisor_tpu_torch.models.raft import RAFT, RAFTConfig
    from flow_supervisor_tpu_torch.ops.coords import coords_grid
    from flow_supervisor_tpu_torch.profile_forward import profile

    bf16 = torch.bfloat16
    launches, times, summary = {}, {}, []
    for backend, batch in CONFIGS:
        gen = torch.Generator().manual_seed(3)
        cfg = RAFTConfig(iters=ITERS, dtype=bf16, corr_dtype=bf16, lookup_backend=backend)
        model = RAFT(cfg, generator=gen).to(dev)
        img1, img2 = (t.to(dev) for t in synthetic_pair(batch, *MAIN_HW, gen))

        def forward():
            return model(img1, img2, final_flow_only=True)

        forward()  # warm-up: cuDNN algorithm choice, allocator
        torch.cuda.synchronize()
        reset_launch_counts()
        out = forward()
        torch.cuda.synchronize()
        got = launch_counts()
        want = {k: 0 for k in SOURCES}
        want.update(ENCODER_LAUNCHES)
        lookup = LOOKUP_KERNEL[(backend, batch)]
        if lookup is not None:
            want[lookup] = LOOKUP_LAUNCHES[lookup]
        flow = out["flow_up"]
        if tuple(flow.shape) != (1, batch, *MAIN_HW, 2) or not torch.isfinite(flow).all():
            raise AssertionError(f"{backend} B={batch}: main path output bad, shape {tuple(flow.shape)}")
        if got != want:
            raise AssertionError(f"{backend} B={batch}: launch counts {got} != expected {want}")
        tc = check_tc_launches(f"{backend} B={batch}", ENCODER_LAUNCHES["conv3x3_stats"])
        check_vector_launches(f"{backend} B={batch}",
                              ENCODER_LAUNCHES["norm_stats"] + ENCODER_LAUNCHES["norm_apply"])
        launches[(backend, batch)] = got
        # the coords of the last (12th) lookup: coords0 + the flow after 11 updates
        h8, w8 = MAIN_HW[0] // 8, MAIN_HW[1] // 8
        coords = (coords_grid(batch, h8, w8, device=dev) + out["flow_low"][-2]).reshape(-1, 2)
        coords = coords.float().contiguous()
        del out, flow

        torch.cuda.reset_peak_memory_stats()
        fwd_ms = time_ms(forward, reps=20, warm=3)
        peak = torch.cuda.max_memory_allocated()
        # device time, idle share and launches of one forward (torch.profiler)
        prof = profile(forward, n=1)
        lookup_kernel = None
        if lookup is not None:
            with torch.no_grad():
                pyramid = model.build_corr(*model.features(img1, img2))
            name, t = lookup_timing(backend, batch, pyramid, coords, dev)
            t["launches"] = got[name]
            times[(backend, batch)] = lookup_kernel = {name: t}
            del pyramid
        del model, img1, img2
        torch.cuda.empty_cache()
        res = {"phase": "main_path", "ok": True, "lookup_backend": backend, "batch": batch,
               "hw": list(MAIN_HW), "iters": ITERS, "dtype": "bfloat16", "launches": got,
               "conv_tensor_core_launches": tc,
               "fwd_ms": fwd_ms, "pairs_per_s": 1000.0 * batch / fwd_ms,
               "peak_mem_bytes": peak, "lookup_kernel": lookup_kernel,
               "device_ms_per_forward": prof.get("device_ms_per_forward"),
               "device_idle_share": prof.get("device_idle_share"),
               "launches_per_forward_all": prof.get("launches_per_forward"),
               "by_category_ms_per_forward": prof.get("by_category_ms_per_forward")}
        emit(res)
        summary.append(res)
    enc = encoder_timing(dev)
    for name, t in enc.items():
        t["launches"] = launches[("plane", 1)][name]
    times[("plane", 1)].update(enc)
    emit({"phase": "main_path", "ok": True, "encoder_kernels_b1": enc})
    for name, (images, hw) in NORM_TIMING.items():
        t = encoder_timing(dev, images, hw, conv=False)
        for k, v in t.items():
            v["launches_per_encoder_call"] = ENCODER_LAUNCHES[k]
        emit({"phase": "main_path", "ok": True, "config": name, "images": images, "hw": list(hw),
              "norm_kernels": t})
    peaks = {(r["lookup_backend"], r["batch"]): r["peak_mem_bytes"] for r in summary}
    saved = peaks[("plane", 8)] - peaks[("fused", 8)]
    emit({"phase": "main_path", "ok": True, "peak_mem_saved_fused_vs_plane_b8_bytes": saved})
    if saved < 1e9:
        raise AssertionError(f"fused B=8 peak memory only {saved} bytes below plane B=8")
    return launches, times


def phase_own_paths(dev):
    """K5 and K11 through their own public functions, the only callers the
    JAX package has (no model path reaches either): ``conv3x3_fused`` at the
    fnet stage shapes of a 448x1024 forward, each as many times as a forward
    runs a 3x3 stride-1 conv there (10 calls, the shapes tools/exp_pconv.py
    times), and ``corr_pyramid_lookup_pallas`` on the fp32 volume pyramid of
    a 448x1024 pair at the coords of its forward's 12 lookups (one launch
    each), with the launch counters reset. Then each is timed against its
    plain version and a library call: ms per forward's convs and per 12
    lookups, device time."""
    import torch
    import torch.nn.functional as F

    from flow_supervisor_tpu_torch.kernels import conv3x3, corr_lookup
    from flow_supervisor_tpu_torch.models.raft import RAFT, RAFTConfig
    from flow_supervisor_tpu_torch.ops.coords import coords_grid
    from flow_supervisor_tpu_torch.ops.corr import build_corr_pyramid_from_fmaps

    gen = torch.Generator().manual_seed(9)
    bf16 = torch.bfloat16
    convs = []
    for shape, cout, n in CONV_SHAPES:
        c = shape[3]
        x = torch.randn(*shape, generator=gen).to(dev, bf16)
        w = (torch.randn(3, 3, c, cout, generator=gen) * (2.0 / (9 * cout)) ** 0.5).to(dev, bf16)
        b = (0.1 * torch.randn(cout, generator=gen)).to(dev, bf16)
        convs.append((x, w, b, n))
    model = RAFT(RAFTConfig(iters=ITERS, dtype=bf16, lookup_backend="fused"), generator=gen).to(dev)
    img1, img2 = (t.to(dev) for t in synthetic_pair(1, *MAIN_HW, gen))
    h8, w8 = MAIN_HW[0] // 8, MAIN_HW[1] // 8
    with torch.no_grad():
        flow_low = model(img1, img2, final_flow_only=True)["flow_low"]
        vols = build_corr_pyramid_from_fmaps(*model.features(img1, img2), LEVELS)
    c0 = coords_grid(1, h8, w8, device=dev)
    coords = [c0] + [(c0 + f).contiguous() for f in flow_low[:-1]]  # lookup i reads coords1
    del model, img1, img2, flow_low

    torch.cuda.synchronize()
    reset_launch_counts()
    ys = [conv3x3.conv3x3_fused(x, w, b) for x, w, b, n in convs for _ in range(n)]
    outs = [corr_lookup.corr_pyramid_lookup_pallas(vols, c, RADIUS) for c in coords]
    torch.cuda.synchronize()
    got = launch_counts()
    want = {k: 0 for k in SOURCES}
    want.update(conv3x3_bare=sum(n for *_, n in convs), corr_lookup_volume=ITERS)
    if got != want:
        raise AssertionError(f"own paths: launch counts {got} != expected {want}")
    check_tc_launches("K5 own path", want["conv3x3_bare"])
    x, w, b, _ = convs[-1]
    e5 = check_close("K5 own path", ys[-1], conv3x3.conv3x3_bare_plain(x, w, b), 1e-2, 1e-5)
    want11 = torch.cat([corr_lookup.lookup_level_plain(v, coords[-1] / 2.0 ** i, RADIUS)
                        for i, v in enumerate(vols)], -1)
    e11 = check_close("K11 own path", outs[-1], want11, 1e-5, 1e-5)
    if tuple(outs[-1].shape) != (1, h8, w8, LEVELS * K2):
        raise AssertionError(f"K11 own path: output shape {tuple(outs[-1].shape)}")
    del ys, outs, want11

    times = {}
    t = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "t_bytes": 0.0,
         "t_ops": 0.0, "per_call": []}
    for x, w, b, n in convs:
        k, p = ab_ms(lambda: conv3x3.conv3x3_fused(x, w, b),
                     lambda: conv3x3.conv3x3_bare_plain(x, w, b))
        xn = x.permute(0, 3, 1, 2)
        wn = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        lib = time_ms(lambda: F.conv2d(xn, wn, b, padding=1), device_only=True)
        bsz, h, wd, c = x.shape
        cout = w.shape[3]
        # K2's operations; bytes: x, w, b read once, y written once (bf16)
        tb, to = bound(2 * (x.numel() + w.numel() + cout + bsz * h * wd * cout),
                       2 * bsz * h * wd * cout * 9 * c, bf16)
        t["ms"] += n * k
        t["plain_ms"] += n * p
        t["library_ms"] += n * lib
        t["bound_ms"] += n * max(tb, to)
        t["t_bytes"] += n * tb
        t["t_ops"] += n * to
        t["per_call"].append([list(x.shape), cout, k, p, lib])
    t["bound_by"] = "bytes" if t.pop("t_bytes") >= t.pop("t_ops") else "operations"
    t["launches"], t["max_abs_err_own_path"] = got["conv3x3_bare"], e5
    times["conv3x3_bare"] = t

    c = coords[-1]
    flat = c.reshape(-1, 2)
    planes = [v.reshape(-1, v.shape[3], v.shape[4]) for v in vols]
    k, p = ab_ms(lambda: corr_lookup.corr_pyramid_lookup_pallas(vols, c, RADIUS),
                 lambda: [corr_lookup.lookup_level_plain(v, c / 2.0 ** i, RADIUS)
                          for i, v in enumerate(vols)])
    library = grid_sample_library(planes, flat, dev)
    lib_ms = time_ms(library, device_only=True)
    del library
    bq = flat.shape[0]
    # K1's tap bytes, from the fp32 volume: the support taps inside the planes
    # at these coords, the coords, and the fp32 output
    shapes = [(lvl, tuple(pl.shape[1:])) for lvl, pl in enumerate(planes)]
    nbytes = support_taps(flat, shapes) * 4 + flat.numel() * 4 + bq * LEVELS * K2 * 4
    tb, to = bound(nbytes, bq * LEVELS * K2 * COMBINE_FLOPS, torch.float32)
    times["corr_lookup_volume"] = {
        "ms": k * ITERS, "plain_ms": p * ITERS, "library_ms": lib_ms * ITERS,
        "bound_ms": max(tb, to) * ITERS, "bound_by": "bytes" if tb >= to else "operations",
        "bytes_per_call": nbytes, "launches": got["corr_lookup_volume"],
        "max_abs_err_own_path": e11}
    del vols, planes
    torch.cuda.empty_cache()
    emit({"phase": "own_paths", "ok": True, "launches": got, "hw": list(MAIN_HW),
          "kernels": times})
    return got, times


def phase_requests(dev):
    import numpy as np
    import torch

    from flow_supervisor_tpu_torch.evaluation import run_pair
    from flow_supervisor_tpu_torch.flo import read_flo, write_flo
    from flow_supervisor_tpu_torch.models.raft import RAFT, RAFTConfig

    gen = torch.Generator().manual_seed(4)
    model = RAFT(RAFTConfig(iters=ITERS), generator=gen).to(dev)
    done = []
    with tempfile.TemporaryDirectory() as tmp:
        for i in range(3):
            img1, img2 = synthetic_pair(1, 436, 1024, gen, shift=(i + 1, 2 * i + 3))
            t0 = time.perf_counter()
            flow, _ = run_pair(model, img1[0].numpy(), img2[0].numpy(), "sintel", iters=ITERS)
            secs = time.perf_counter() - t0
            path = os.path.join(tmp, f"frame_{i:04d}.flo")
            write_flo(path, flow)
            back = read_flo(path)
            if back.shape != (436, 1024, 2) or not np.isfinite(back).all():
                raise AssertionError(f"{path}: bad flow read back, shape {back.shape}")
            if not np.array_equal(back, flow):
                raise AssertionError(f"{path}: read back differs from what was written")
            done.append({"file": os.path.basename(path), "shape": list(back.shape),
                         "seconds": secs, "mean_flow_px": float(np.abs(back).mean())})
    emit({"phase": "requests", "ok": True, "mode": "sintel", "padded_hw": [440, 1024],
          "dtype": "float32", "pairs": done})


def eval_frames(n, h, w, gen, step=(2, 3)):
    """n smooth random frames [H, W, 3] uint8, each shifted by step (dy, dx)
    pixels from the one before: the flow from each to the next is
    (-dx, -dy) everywhere."""
    import torch
    import torch.nn.functional as F

    dy, dx = step
    big_h, big_w = h + dy * n, w + dx * n
    low = torch.rand(1, 3, big_h // 16 + 2, big_w // 16 + 2, generator=gen)
    big = F.interpolate(low, size=(big_h, big_w), mode="bilinear", align_corners=False)[0]
    big = (big.permute(1, 2, 0) * 255.0).round().clamp(0, 255).to(torch.uint8).numpy()
    return [big[i * dy : i * dy + h, i * dx : i * dx + w] for i in range(n)]


def write_checked_png(path, arr):
    """write_png, then read the file back: the samples must be what was written."""
    import numpy as np

    from flow_supervisor_tpu_torch.data.io import read_png, write_png

    write_png(path, arr)
    back = read_png(path)
    if back.dtype != arr.dtype or not np.array_equal(back.reshape(arr.shape), arr):
        raise AssertionError(f"{path}: the PNG read back differs from what was written")


def write_eval_tree(root, gen, sintel_hw, kitti_hw, sintel_frames=EVAL_SINTEL_FRAMES):
    """A Sintel training tree (one scene of `sintel_frames` frames, clean and
    final, .flo labels) and a KITTI training tree (EVAL_KITTI_PAIRS pairs,
    16-bit flow PNGs with about 30 % of the pixels valid) under root, with
    the port's own writers; each PNG is read back and checked. The final
    pass is the clean one with noise."""
    import numpy as np

    from flow_supervisor_tpu_torch.data.io import write_flo

    rng = np.random.default_rng(11)
    step = (2, 3)
    flow = np.broadcast_to(np.float32([-step[1], -step[0]]), (*sintel_hw, 2)).copy()
    frames = eval_frames(sintel_frames, *sintel_hw, gen, step)
    for dstype in ("clean", "final"):
        d = os.path.join(root, "Sintel/training", dstype, "alley_1")
        os.makedirs(d)
        for i, img in enumerate(frames):
            if dstype == "final":
                img = np.clip(img + rng.normal(0, 4, img.shape), 0, 255).astype(np.uint8)
            write_checked_png(os.path.join(d, f"frame_{i:04d}.png"), img)
    fd = os.path.join(root, "Sintel/training/flow/alley_1")
    os.makedirs(fd)
    for i in range(sintel_frames - 1):
        write_flo(os.path.join(fd, f"frame_{i:04d}.flo"), flow)
    k = os.path.join(root, "KITTI/data_scene_flow/training")
    os.makedirs(os.path.join(k, "image_2"))
    os.makedirs(os.path.join(k, "flow_occ"))
    for i in range(EVAL_KITTI_PAIRS):
        a, b = eval_frames(2, *kitti_hw, gen, step)
        write_checked_png(os.path.join(k, "image_2", f"{i:06d}_10.png"), a)
        write_checked_png(os.path.join(k, "image_2", f"{i:06d}_11.png"), b)
        raw = np.zeros((*kitti_hw, 3), np.uint16)
        raw[..., 0] = 2 ** 15 - 64 * step[1]
        raw[..., 1] = 2 ** 15 - 64 * step[0]
        raw[..., 2] = rng.random(kitti_hw) < 0.3
        write_checked_png(os.path.join(k, "flow_occ", f"{i:06d}_10.png"), raw)


def check_eval_result(where, res, sparse, teacher=True):
    """Raises unless every metric is finite and in its range."""
    names = ["student"] + (["teacher"] if teacher else [])
    keys = ["epe", "epe_1px", "epe_3px", "epe_5px"] + (["fl"] if sparse else [])
    for n in names:
        for k in keys:
            v = res.get(f"{n}_{k}")
            ok = v is not None and math.isfinite(v) and v >= 0.0 and (k == "epe" or v <= 1.0)
            if not ok:
                raise AssertionError(f"{where}: {n}_{k} = {v} out of range: {res}")
    if not res["pairs_per_sec"] > 0.0:
        raise AssertionError(f"{where}: pairs_per_sec {res['pairs_per_sec']}")


def eval_launch_check(where, got, pairs, iters, teacher_iters):
    """Raises unless a run of `pairs` pairs launched K6 (iters + teacher_iters)
    times a pair, K2 / K3 / K4 their encoder counts a pair and nothing else."""
    want = {k: 0 for k in SOURCES}
    want.update({k: pairs * v for k, v in ENCODER_LAUNCHES.items()})
    want["corr_fused_all"] = pairs * (iters + teacher_iters)
    if got != want:
        raise AssertionError(f"{where}: launch counts {got} != expected {want}")
    return {k: v / pairs for k, v in got.items() if v}


@contextlib.contextmanager
def data_root(root: str):
    """The port's dataset catalog reads ``root`` (FST_DATA_ROOT, with
    ``data.paths`` reloaded) inside the block, and what it read before after."""
    import importlib

    from flow_supervisor_tpu_torch.data import paths

    old_root = os.environ.get("FST_DATA_ROOT")
    os.environ["FST_DATA_ROOT"] = root
    importlib.reload(paths)
    try:
        yield
    finally:
        if old_root is None:
            os.environ.pop("FST_DATA_ROOT", None)
        else:
            os.environ["FST_DATA_ROOT"] = old_root
        importlib.reload(paths)


def phase_evaluate(dev):
    """The Evaluator over Sintel and KITTI trees written by the port's own
    writers (``write_eval_tree``), on a full-width flow-supervisor RAFT with
    its teacher head (random weights, fp32, the auto lookup: fused on the
    card): Sintel at 436x1024, 32 student + 12 teacher iterations, warm
    start within the scene, both passes; KITTI at 375x1242, 24 + 12, sparse,
    pad_bucket 8 and 64. Launch counts per pair, metrics in range, pairs/s,
    host ms per pair (decode, warm start, forward), device ms and idle share
    of one pair (profiler), peak memory, and decode ms per frame. Then the
    same Evaluator on the card against the CPU at 216x512, 4 iterations,
    dense with warm start and sparse."""
    import numpy as np
    import torch

    from flow_supervisor_tpu_torch.data import datasets as D
    from flow_supervisor_tpu_torch.data.io import read_flow_kitti, read_image
    from flow_supervisor_tpu_torch.data.pipeline import load_record
    from flow_supervisor_tpu_torch.evaluation import Evaluator
    from flow_supervisor_tpu_torch.models.raft import RAFT, RAFTConfig
    from flow_supervisor_tpu_torch.profile_forward import profile
    from flow_supervisor_tpu_torch.utils.warm_start import forward_interpolate

    gen = torch.Generator().manual_seed(12)
    model = RAFT(RAFTConfig(teacher=True, teacher_iters=EVAL_TEACHER_ITERS, lookup_backend="auto"),
                 generator=gen)
    cpu_model = RAFT(RAFTConfig(teacher=True, teacher_iters=EVAL_TEACHER_ITERS,
                                lookup_backend="auto"))
    cpu_model.load_state_dict(model.state_dict())
    model.to(dev)
    results = []
    with tempfile.TemporaryDirectory() as tmp, data_root(tmp):
        t0 = time.perf_counter()
        write_eval_tree(tmp, gen, EVAL_SINTEL_HW, EVAL_KITTI_HW)
        write_s = time.perf_counter() - t0
        sintel = {p: D.sintel(True, p) for p in ("clean", "final")}
        kitti = D.kitti(True)
        frame = sintel["clean"][0].images[0]
        decode_ms = {"sintel_frame_png": 1e3 * min(
                         timed(lambda: read_image(frame)) for _ in range(3)),
                     "kitti_flow_png": 1e3 * min(
                         timed(lambda: read_flow_kitti(kitti[0].flow)) for _ in range(3))}
        # warm-up: cuDNN's algorithm choice at both shapes, the allocator
        Evaluator(model, iters=2).evaluate(sintel["clean"][:1])
        Evaluator(model, iters=2, pad_bucket=64).evaluate(kitti[:1], sparse=True)
        runs = [("sintel", p, EVAL_SINTEL_ITERS, 8, False, True, sintel[p])
                for p in ("clean", "final")]
        runs += [("kitti", "training", EVAL_KITTI_ITERS, bucket, True, False, kitti)
                 for bucket in (8, 64)]
        for name, split, iters, bucket, sparse, warm, recs in runs:
            ev = Evaluator(model, iters=iters, pad_bucket=bucket)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            res = ev.evaluate(recs, sparse=sparse, warm_start=warm)
            torch.cuda.synchronize()
            where = f"evaluate {name} {split} pad_bucket {bucket}"
            per_pair = eval_launch_check(where, launch_counts(), len(recs), iters,
                                         EVAL_TEACHER_ITERS)
            check_eval_result(where, res, sparse)
            peak = torch.cuda.max_memory_allocated()
            # device time and idle share of one pair as the Evaluator runs it
            img1, img2, _, _ = load_record(recs[-1])
            init = None
            if warm:
                _, low = ev.predict(*load_record(recs[-2])[:2], "sintel")
                init = forward_interpolate(low)
            prof = profile(lambda: ev.predict(img1, img2, "kitti" if sparse else "sintel",
                                              init), n=1)
            row = {"phase": "evaluate", "ok": True, "dataset": name, "split": split,
                   "hw": list(img1.shape[:2]), "pad_bucket": bucket, "pairs": len(recs),
                   "iters": iters, "teacher_iters": EVAL_TEACHER_ITERS, "warm_start": warm,
                   "dtype": "float32", "lookup_backend": "auto (fused)",
                   "launches_per_pair": per_pair, "metrics": res,
                   "pairs_per_s": res["pairs_per_sec"],
                   "host_ms_per_pair": {k: res[f"{k}_ms_per_pair"]
                                        for k in ("decode", "warm_start", "forward")},
                   "device_ms_per_pair": prof.get("device_ms_per_forward"),
                   "device_idle_share": prof.get("device_idle_share"),
                   "launches_per_pair_all": prof.get("launches_per_forward"),
                   "by_category_ms_per_pair": prof.get("by_category_ms_per_forward"),
                   "peak_mem_bytes": peak}
            emit(row)
            results.append(row)
        emit({"phase": "evaluate", "ok": True, "decode_ms": decode_ms,
              "tree_write_s": write_s})
    # the same Evaluator on the card against the CPU (plain versions; auto
    # is einsum there) at 216x512
    with tempfile.TemporaryDirectory() as tmp, data_root(tmp):
        write_eval_tree(tmp, gen, EVAL_PARITY_HW, EVAL_PARITY_HW, sintel_frames=3)
        for name, recs, sparse in (("sintel", D.sintel(True, "clean"), False),
                                   ("kitti", D.kitti(True), True)):
            got = Evaluator(model, iters=EVAL_PARITY_ITERS).evaluate(
                recs, sparse=sparse, warm_start=not sparse)
            ref = Evaluator(cpu_model, iters=EVAL_PARITY_ITERS).evaluate(
                recs, sparse=sparse, warm_start=not sparse)
            diffs = {k: abs(got[k] - ref[k]) for k in ref
                     if k.startswith(("student_", "teacher_"))}
            ok = bool(diffs) and all(
                d < (EVAL_PARITY_EPE if k.endswith("_epe") else EVAL_PARITY_SHARE)
                for k, d in diffs.items())
            row = {"phase": "evaluate", "check": "card_vs_cpu", "dataset": name,
                   "hw": list(EVAL_PARITY_HW), "pairs": len(recs), "iters": EVAL_PARITY_ITERS,
                   "teacher_iters": EVAL_TEACHER_ITERS, "warm_start": not sparse,
                   "dtype": "float32", "ran": {"gpu": "fused", "cpu": "einsum"},
                   "max_abs_diff": diffs, "gpu": got, "cpu": ref, "ok": ok}
            emit(row)
            if not ok:
                raise AssertionError(f"evaluate card-vs-CPU parity failed: {row}")
    return results


def timed(fn) -> float:
    """Seconds of one call of fn, by the host clock."""
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def noise_bias(name: str, bn_train: bool = False) -> bool:
    """A conv bias whose gradient is zero in exact arithmetic, fp32 noise in
    practice (``parallel.dryrun.noise_bias``)."""
    from flow_supervisor_tpu_torch.parallel.dryrun import noise_bias as rule

    return rule(name, bn_train)


def flow_label(b, h, w, gen):
    """(flow [b, h, w, 2], valid [b, h, w, 1]): a smooth random flow with
    about 10 % of its pixels invalid, CPU tensors."""
    import torch
    import torch.nn.functional as F

    low = 4.0 * torch.randn(b, 2, h // 32 + 2, w // 32 + 2, generator=gen)
    flow = F.interpolate(low, size=(h, w), mode="bilinear").permute(0, 2, 3, 1).contiguous()
    return flow, (torch.rand(b, h, w, 1, generator=gen) > 0.1).float()


def recipe_batches(sup_hw, unsup_hw, full_hw, gen, sup_yx, unsup_yx):
    """(sup, unsup) batches of the semi step's contract, B=1, CPU tensors:
    smooth random frames, crops at (y, x), and for sup a smooth random flow
    label with about 10 % of its pixels invalid. The unsup batch is also the
    Unsup step's."""
    import torch

    out = []
    for (h, w), (y, x), shift in ((sup_hw, sup_yx, (2, 3)), (unsup_hw, unsup_yx, (4, 1))):
        full1, full2 = synthetic_pair(1, *full_hw, gen, shift=shift)
        out.append({"image1": full1[:, y : y + h, x : x + w].contiguous(),
                    "image2": full2[:, y : y + h, x : x + w].contiguous(),
                    "orig_image1": full1, "orig_image2": full2,
                    "crop_yx": torch.tensor([[y, x]])})
    out[0]["flow"], out[0]["valid"] = flow_label(1, *sup_hw, gen)
    return out[0], out[1]


def labeled_batch(b, hw, gen):
    """A Baseline batch, CPU tensors: smooth random pairs [b, h, w, 3] and a
    smooth random flow label."""
    img1, img2 = synthetic_pair(b, *hw, gen)
    flow, valid = flow_label(b, *hw, gen)
    return {"image1": img1, "image2": img2, "flow": flow, "valid": valid}


def parity_cfg(kind: str):
    """The card-vs-CPU step's config for a step kind: the recipe's at fp32
    with PARITY_ITERS iterations."""
    from flow_supervisor_tpu_torch.config import ExperimentConfig, ModelCfg, TrainCfg

    model, train = STEP_RECIPES[kind]
    return ExperimentConfig(
        ModelCfg(**dict(model, iters=PARITY_ITERS, teacher_iters=PARITY_ITERS,
                        compute_dtype="float32")),
        TrainCfg(**train))


def step_parity_setup(kind: str):
    """The train-parity step of a kind ("semi", "unsup", "smurf",
    "baseline"): its config, random weights (a state dict) with non-trivial
    batch-norm statistics and affine parameters, and its batch, cut as 64x96
    crops of 96x128 frames (Baseline: B=2, 64x96)."""
    import torch

    from flow_supervisor_tpu_torch.training.loop import build_model

    gen = torch.Generator().manual_seed(6)
    cfg = parity_cfg(kind)
    base = build_model(cfg, gen)
    for m in base.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            for t in (m.running_mean, m.running_var, m.weight, m.bias):
                t.data.uniform_(0.5, 1.5, generator=gen)
    if kind == "baseline":
        batch = labeled_batch(2, (64, 96), gen)
    else:
        batch = recipe_batches((64, 96), (64, 96), (96, 128), gen, (16, 8), (24, 32))
        batch = batch[1] if kind == "unsup" else batch
    return cfg, base.state_dict(), batch


def to_device(batch, device):
    """A batch dict, or a (sup, unsup) pair of them, on ``device``."""
    if isinstance(batch, tuple):
        return tuple(to_device(b, device) for b in batch)
    return {k: v.to(device) for k, v in batch.items()}


def step_outputs(cfg, weights, batch, device, update_ckpt: bool = False):
    """One train step of cfg's model type from ``weights`` on ``device`` ->
    (logs, gradients, parameters after the step, parameters before, how far
    the step moved each running batch-norm statistic), on the CPU.
    ``update_ckpt``: remat each refinement iteration."""
    from flow_supervisor_tpu_torch.training.loop import build_model, make_step
    from flow_supervisor_tpu_torch.training.optim import batchnorm_params, make_optimizer
    from flow_supervisor_tpu_torch.training.state import TrainState

    model = build_model(cfg, update_ckpt=update_ckpt)
    model.load_state_dict(weights)
    model.to(device)
    before = {k: v.detach().cpu().clone() for k, v in model.named_parameters()}
    frozen = batchnorm_params(model) if model.cfg.freeze_bn else ()
    state = TrainState.create(dict(model.named_parameters()), make_optimizer(cfg.train, frozen))
    state, log = make_step(model, cfg, debug_grads=True)(state, to_device(batch, device))
    grads = {k: g.detach().cpu() for k, g in log.pop("_grads").items()}
    params = {k: p.detach().cpu() for k, p in state.params.items()}
    stat_updates = {k: v.detach().cpu() - weights[k] for k, v in model.state_dict().items()
                    if k.endswith(("running_mean", "running_var"))}
    return {k: float(v) for k, v in log.items()}, grads, params, before, stat_updates


def parity_errors(run, ref, lr, bn_train: bool = False):
    """How far one step's outputs (``step_outputs``) lie from a reference
    step's: losses, per-variable gradients and updates, and the updates of
    the running statistics where batch norm trains."""
    import torch

    (lg, gr, pr, before), (lc, gc, pc, _) = run[:4], ref[:4]
    upd = torch.cat([((pr[k] - before[k]) - (pc[k] - before[k])).abs().flatten()
                     for k in pc if not noise_bias(k, bn_train)]) / lr
    l2 = {k: float((gr[k] - gc[k]).norm() / gc[k].norm())
          for k in gc if not noise_bias(k, bn_train) and gc[k].norm() > 0}
    err = {
        "max_rel_err_losses": max(abs(lg[k] - lc[k]) / max(abs(lc[k]), 1e-30) for k in lc),
        "max_grad_l2": max(l2.values()),
        "max_fnet_grad_l2": max(v for k, v in l2.items() if k.startswith("fnet.")),
        "worst_grad_vars": sorted(l2, key=l2.get)[-3:],
        "max_noise_bias_grad_rel_to_weight": max(
            float(torch.maximum(gr[k].abs().max(), gc[k].abs().max())
                  / gc[k[: -len("bias")] + "weight"].abs().max())
            for k in gc if noise_bias(k, bn_train)),
        "max_rel_err_params": max(float((pr[k] - pc[k]).abs().max() / pc[k].abs().max())
                                  for k in pc),
        "max_update_err_lr": float(upd.max()),
        "share_updates_within_1e-2_lr": float((upd <= 1e-2).float().mean()),
        "finite": all(math.isfinite(v) for v in lg.values()),
    }
    if len(run) > 4 and bn_train:
        err["max_rel_err_running_stats_update"] = max(
            float((run[4][k] - ref[4][k]).abs().max() / ref[4][k].abs().max()) for k in ref[4])
    return err


def parity_ok(err, kind: str = "semi") -> bool:
    """The limits of the card-vs-CPU train step of a kind (see PARITY_*)."""
    share = PARITY_UPDATE_SHARE_BY_STEP.get(kind, PARITY_UPDATE_SHARE)
    return bool(
        err["finite"] and err["max_rel_err_losses"] < PARITY_LOSS_REL
        and err["max_grad_l2"] < PARITY_GRAD_L2 and err["max_fnet_grad_l2"] < PARITY_FNET_GRAD_L2
        and err["max_noise_bias_grad_rel_to_weight"] < PARITY_NOISE_BIAS
        and err["max_update_err_lr"] <= PARITY_UPDATE_MAX_LR
        and err["share_updates_within_1e-2_lr"] >= share
        and err.get("max_rel_err_running_stats_update", 0.0) < PARITY_STATS_UPDATE_REL)


def phase_train_parity(dev):
    """One train step of each kind on the card (fp32, TF32 off) against the
    same step on the CPU (plain versions), same weights and batches
    (``step_parity_setup``)."""
    import torch

    from flow_supervisor_tpu_torch.training.loop import frozen_bn

    for kind in STEP_RECIPES:
        cfg, weights, batch = step_parity_setup(kind)
        ref = step_outputs(cfg, weights, batch, torch.device("cpu"))
        run = step_outputs(cfg, weights, batch, dev)
        err = parity_errors(run, ref, cfg.train.lr, bn_train=not frozen_bn(cfg))
        res = {"phase": "train_parity", "step": kind, "crop_hw": [64, 96],
               "full_hw": None if kind == "baseline" else [96, 128], "iters": PARITY_ITERS,
               "dtype": "float32", "logs_cpu": ref[0], "logs_gpu": run[0], **err,
               "ok": parity_ok(err, kind)}
        emit(res)
        if not res["ok"]:
            raise AssertionError(f"{kind} train step card-vs-CPU parity failed: {res}")


def bwd_lookup_inputs(model, batch, forward: str = "semi"):
    """(fused pyramid, coords [B*Q, 2]) of a train step's last student lookup
    on `batch`: the model's pyramid of the batch's pair and the pixel grid
    plus the flow before the last iteration, from ``semi_forward``'s student
    (forward "semi") or the plain forward (the Baseline step's)."""
    import torch

    from flow_supervisor_tpu_torch.ops.coords import coords_grid

    with torch.no_grad():
        if forward == "semi":
            low = model.semi_forward(batch["image1"], batch["image2"], batch["orig_image1"],
                                     batch["orig_image2"], batch["crop_yx"], use_bw=False,
                                     teacher_final_only=True, teacher_grad=False)["student_low_fw"]
        else:
            low = model(batch["image1"], batch["image2"])["flow_low"]
        b, h8, w8 = low.shape[1:4]
        coords = coords_grid(b, h8, w8, device=low.device) + low[-2]
        pyr = model.build_corr(*model.features(batch["image1"], batch["image2"]))
    return pyr, coords.reshape(-1, 2).float().contiguous()


def train_bwd_timing(model, shapes, dev, radius=RADIUS):
    """K8 / K9 against their plain versions on the inputs of a step's last
    student lookups (``bwd_lookup_inputs``) at each of `shapes`, (name, batch,
    forward, calls per step): ms per step (per-call device time x calls), the
    card's least time for them and its share, and K8's and K9's (level,
    tile) pairs by path."""
    import torch

    from flow_supervisor_tpu_torch.kernels import corr_fused

    gen = torch.Generator().manual_seed(8)
    times = {n: {"ms": 0.0, "plain_ms": 0.0, "library_ms": None, "bound_ms": 0.0,
                 "t_bytes": 0.0, "t_ops": 0.0, "per_call": {}} for n in ("bwd_df1", "bwd_df2")}
    for name, batch, forward, calls in shapes:
        pyr, coords = bwd_lookup_inputs(model, batch, forward)
        f1, f2s = pyr.f1, pyr.f2s
        g = torch.randn(coords.shape[0], LEVELS * (2 * radius + 1) ** 2,
                        generator=gen).to(dev, f1.dtype)
        levels = [(lvl, tuple(f2.shape[1:3])) for lvl, f2 in enumerate(f2s)]
        ops = 2 * f1.shape[2] * support_taps(coords, levels, radius)
        common = g.numel() * g.element_size() + coords.numel() * 4
        f2_bytes = sum(f2.numel() * f2.element_size() for f2 in f2s)
        f1_bytes = f1.numel() * f1.element_size()
        for kname, kernel, plain, nbytes in (
            # K8 reads g, coords and f2, writes d_f1 in f1's dtype
            ("bwd_df1", corr_fused.bwd_df1, corr_fused.bwd_df1_plain, common + f2_bytes + f1_bytes),
            # K9 reads g, coords and f1, writes d_f2 in f2's dtype
            ("bwd_df2", corr_fused.bwd_df2, corr_fused.bwd_df2_plain, common + f1_bytes + f2_bytes),
        ):
            k, p = ab_ms(lambda: kernel(f1, f2s, coords, g, radius),
                         lambda: plain(f1, f2s, coords, g, radius))
            tb, to = bound(nbytes, ops, f1.dtype)
            t = times[kname]
            t["ms"] += calls * k
            t["plain_ms"] += calls * p
            t["bound_ms"] += calls * max(tb, to)
            t["t_bytes"] += calls * tb
            t["t_ops"] += calls * to
            t["per_call"][name] = {"batch": f1.shape[0], "queries": coords.shape[0],
                                   "calls_per_step": calls, "ms": k, "plain_ms": p,
                                   "bound_ms": max(tb, to), "bound_share": max(tb, to) / k,
                                   "bytes": nbytes, "ops": ops}
            t["per_call"][name].update(tile_paths(f1, f2s, coords, radius))
        del pyr
    for t in times.values():
        t["bound_by"] = "bytes" if t.pop("t_bytes") >= t.pop("t_ops") else "operations"
        t["bound_share"] = t["bound_ms"] / t["ms"]
    return times


def train_main(dev, kind: str, batches, **shapes):
    """One recipe's step at full width through ``training.loop.train`` (the
    main path: launch counts over its steps), then steps/s over timed steps,
    peak memory, and device time, idle share and launches of one step.
    Returns (launch counts, the model, the batches on the card, the result)."""
    import itertools

    import torch

    from flow_supervisor_tpu_torch.config import ExperimentConfig, ModelCfg, TrainCfg
    from flow_supervisor_tpu_torch.profile_forward import profile
    from flow_supervisor_tpu_torch.training.loop import make_step, train

    model_kw, train_kw = {**STEP_RECIPES, **MODEL_RECIPES}[kind]
    # an empty dataset root: no standing validation set, so ``train`` runs
    # the steps alone whatever the working directory holds
    with tempfile.TemporaryDirectory() as tmp, data_root(os.path.join(tmp, "no_datasets")):
        cfg = ExperimentConfig(ModelCfg(**model_kw, compute_dtype="bfloat16"),
                               TrainCfg(**train_kw, seed=7), ckpt_dir=tmp)
        torch.cuda.synchronize()
        reset_launch_counts()
        model, state = train(cfg, itertools.cycle(batches), max_steps=TRAIN_STEPS_MAIN, device=dev)
        torch.cuda.synchronize()
        got = launch_counts()
        with open(os.path.join(tmp, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
    want = {k: 0 for k in SOURCES}
    want.update({k: TRAIN_STEPS_MAIN * v for k, v in STEP_LAUNCHES[kind].items()})
    if got != want:
        raise AssertionError(f"{kind} train main path: launch counts {got} != expected {want}")
    tc = check_tc_launches(f"{kind} train main path", want["conv3x3_stats"])
    check_vector_launches(f"{kind} train main path", want["norm_stats"] + want["norm_apply"])
    if len(rows) != TRAIN_STEPS_MAIN or not all(
            math.isfinite(v) for r in rows for v in r.values() if isinstance(v, float)):
        raise AssertionError(f"{kind} train main path: bad metrics rows {rows}")

    step = make_step(model, cfg)
    dev_batches = [to_device(b, dev) for b in batches]
    holder = {"state": state, "i": 0}

    def one():
        holder["state"], log = step(holder["state"], dev_batches[holder["i"] % len(dev_batches)])
        holder["i"] += 1
        return log

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TRAIN_STEPS_TIMED):
        log = one()
    end.record()
    end.synchronize()
    step_ms = start.elapsed_time(end) / TRAIN_STEPS_TIMED
    peak = torch.cuda.max_memory_allocated()
    log = {k: float(v) for k, v in log.items()}
    if not all(math.isfinite(v) for v in log.values()):
        raise AssertionError(f"{kind} train main path: non-finite log {log}")
    prof = profile(one, n=1)
    res = {"phase": "train_main", "ok": True, "step": kind, "recipe": RECIPE_NAMES[kind],
           **{k: list(v) if isinstance(v, tuple) else v for k, v in shapes.items()},
           "iters": ITERS, "dtype": "bfloat16", "main_path_steps": TRAIN_STEPS_MAIN,
           "launches": got, "launches_per_step": {k: v // TRAIN_STEPS_MAIN for k, v in got.items()},
           "conv_tensor_core_launches": tc,
           "metrics_rows": rows, "timed_steps": TRAIN_STEPS_TIMED, "step_ms": step_ms,
           "steps_per_s": 1000.0 / step_ms, "peak_mem_bytes": peak, "last_log": log,
           "device_ms_per_step": prof.get("device_ms_per_forward"),
           "device_idle_share": prof.get("device_idle_share"),
           "launches_per_step_all": prof.get("launches_per_forward"),
           "by_category_ms_per_step": prof.get("by_category_ms_per_forward"),
           "launches_by_category_per_step": prof.get("launches_by_category_per_forward")}
    return got, model, dev_batches, res


def phase_train_main(dev):
    """Each recipe's step at full width and full shapes (``train_main``): the
    Sintel semi step, whose K8 / K9 are then timed against their plain
    versions (the kernels' home), the KITTI semi step with the teacher SMURF
    loss, the Unsup step and the chairs Baseline step. Returns the Sintel
    semi step's launch counts and K8 / K9 times."""
    import torch

    gen = torch.Generator().manual_seed(7)
    batches = [recipe_batches(TRAIN_SUP, TRAIN_UNSUP, TRAIN_FULL, gen, (16, 152), (32, 128)),
               recipe_batches(TRAIN_SUP, TRAIN_UNSUP, TRAIN_FULL, gen, (24, 296), (56, 256))]
    got, model, dev_batches, res = train_main(
        dev, "semi", batches, batch=1, sup_hw=TRAIN_SUP, unsup_hw=TRAIN_UNSUP, full_hw=TRAIN_FULL)
    times = train_bwd_timing(model, [(name, batch, "semi", TRAIN_BWD_CALLS[name])
                                     for name, batch in zip(("sup", "unsup"), dev_batches[0])], dev)
    for name, t in times.items():
        t["launches"] = got[name]
    res.update(teacher_iters=ITERS, bwd_kernels=times)
    emit(res)
    semi_res = res
    del model, dev_batches
    torch.cuda.empty_cache()

    kitti = [recipe_batches(KITTI_SUP, KITTI_UNSUP, KITTI_FULL, gen, (8, 296), (40, 128)),
             recipe_batches(KITTI_SUP, KITTI_UNSUP, KITTI_FULL, gen, (0, 600), (80, 600))]
    unsup = [recipe_batches(TRAIN_SUP, TRAIN_UNSUP, TRAIN_FULL, gen, (0, 0), yx)[1]
             for yx in ((32, 128), (64, 256))]
    chairs = [labeled_batch(CHAIRS_BATCH, CHAIRS_HW, gen) for _ in range(2)]
    for kind, bs, shapes in (
        ("smurf", kitti, dict(batch=1, sup_hw=KITTI_SUP, unsup_hw=KITTI_UNSUP, full_hw=KITTI_FULL,
                              teacher_iters=ITERS)),
        ("unsup", unsup, dict(batch=1, crop_hw=TRAIN_UNSUP, full_hw=TRAIN_FULL)),
        ("baseline", chairs, dict(batch=CHAIRS_BATCH, hw=CHAIRS_HW)),
    ):
        _, model, dev_batches, res = train_main(dev, kind, bs, **shapes)
        if kind == "baseline":  # K8 / K9 at B=10 beside the semi step's B=1
            res["bwd_kernels"] = train_bwd_timing(
                model, [("chairs", dev_batches[0], "baseline", ITERS)], dev)
        emit(res)
        del model, dev_batches
        torch.cuda.empty_cache()
    return got, times, semi_res


def k12_checks(dev):
    """K12 against its plain version (``ops.corr.lookup_vjp_dvols``) at
    ``K12_SHAPES``, radius 4 and 3 (the small model's), four levels, coords
    in, partly and far out of bounds: fp32 and bf16 cotangents (K10's and
    K1's), fp32 and bf16 planes. Every result must be the plain version's
    bits; against the fp32 value of the same cotangent, an fp32 result must
    lie within 1e-5 of the largest |d_plane| and a bf16 one within one bf16
    ulp. Returns (rows, the largest |error| against that fp32 value)."""
    import torch

    from flow_supervisor_tpu_torch.kernels import corr_plane
    from flow_supervisor_tpu_torch.ops.corr import lookup_vjp_dvols

    gen = torch.Generator().manual_seed(17)
    rows, worst = [], 0.0
    for name, (h8, w8) in K12_SHAPES:
        shapes = [(-(-h8 // 2 ** lvl), -(-w8 // 2 ** lvl)) for lvl in range(LEVELS)]
        for radius in (RADIUS, SMALL_RADIUS):
            coords = check_coords(h8 * w8, h8, w8, gen, dev)
            g32 = torch.randn(h8 * w8, LEVELS * (2 * radius + 1) ** 2, generator=gen).to(dev)
            for g in (g32, g32.bfloat16()):
                ref = lookup_vjp_dvols(g.float(), coords, shapes, radius, torch.float32)
                largest = max(float(r.abs().max()) for r in ref)
                for out_dtype in (torch.float32, torch.bfloat16):
                    what = f"K12 {name} {h8}x{w8} r={radius} g {g.dtype} out {out_dtype}"
                    got = corr_plane.lookup_bwd(g, coords, shapes, radius, out_dtype)
                    want = lookup_vjp_dvols(g, coords, shapes, radius, out_dtype)
                    if not all(torch.equal(a, b) for a, b in zip(got, want)):
                        raise AssertionError(f"{what}: not the plain version's bits")
                    if g.dtype == torch.float32 and out_dtype == torch.float32:
                        err = max(check_close(what, a, b, 0.0, 1e-5 * largest)
                                  for a, b in zip(got, ref))
                    else:
                        err = max(check_ulp(what, a, b, 0.0) for a, b in zip(got, ref))
                    worst = max(worst, err)
                    rows.append({"shape": name, "hw8": [h8, w8], "radius": radius,
                                 "g_dtype": str(g.dtype), "out_dtype": str(out_dtype),
                                 "plain_bits": True, "max_abs_err_vs_fp32": err,
                                 "largest_abs": largest})
                    del got, want
                del ref
    return rows, worst


def k12_timing(model, batch_pair, dev, g_dtype):
    """K12 against its plain version and the library's transposed sampler
    (``grid_sampler_2d_backward``, one call a level) on the coords and plane
    shapes of a semi step's last student lookups (``bwd_lookup_inputs``;
    sup and unsup crops) and a random cotangent in ``g_dtype``: ms per step
    (per-call device time x the step's calls), and the card's least time for
    them: the d_plane written once, g and coords read once."""
    import torch

    from flow_supervisor_tpu_torch.kernels import corr_plane
    from flow_supervisor_tpu_torch.ops.corr import lookup_vjp_dvols

    gen = torch.Generator().manual_seed(18)
    t = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "per_call": {}}
    t_bytes = t_ops = 0.0
    for name, batch in zip(("sup", "unsup"), batch_pair):
        calls = TRAIN_BWD_CALLS[name]
        planes, coords = bwd_lookup_inputs(model, batch)
        shapes = [tuple(p.shape[1:]) for p in planes]
        out_dtype, bq = planes[0].dtype, coords.shape[0]
        g = torch.randn(bq, LEVELS * K2, generator=gen).to(dev, g_dtype)
        k, p = ab_ms(lambda: corr_plane.lookup_bwd(g, coords, shapes, RADIUS, out_dtype),
                     lambda: lookup_vjp_dvols(g, coords, shapes, RADIUS, out_dtype))
        grids = window_grids(shapes, coords, dev)
        g_lv = [g[:, lvl * K2:(lvl + 1) * K2].float().reshape(bq, 1, 2 * RADIUS + 1, -1)
                for lvl in range(LEVELS)]
        p32 = [pl.float()[:, None] for pl in planes]

        def library():
            return [torch.ops.aten.grid_sampler_2d_backward(gl, pl, gr, 0, 0, True,
                                                            [True, False])[0]
                    for gl, pl, gr in zip(g_lv, p32, grids)]

        lib_err = max(float((a[:, 0] - b.float()).abs().max()) for a, b in zip(
            library(), lookup_vjp_dvols(g.float(), coords, shapes, RADIUS, torch.float32)))
        lib = time_ms(library, device_only=True)
        out_bytes = bq * sum(h * w for h, w in shapes) * planes[0].element_size()
        nbytes = out_bytes + g.numel() * g.element_size() + coords.numel() * 4
        # the transposed lerp: 4 products and 3 sums per support element, fp32
        ops = bq * LEVELS * (2 * RADIUS + 2) ** 2 * COMBINE_FLOPS
        tb, to = bound(nbytes, ops, torch.float32)
        t["ms"] += calls * k
        t["plain_ms"] += calls * p
        t["library_ms"] += calls * lib
        t["bound_ms"] += calls * max(tb, to)
        t_bytes += calls * tb
        t_ops += calls * to
        t["per_call"][name] = {"queries": bq, "shapes": shapes, "calls_per_step": calls,
                               "g_dtype": str(g_dtype), "out_dtype": str(out_dtype), "ms": k,
                               "plain_ms": p, "library_ms": lib, "library_max_abs_err": lib_err,
                               "bound_ms": max(tb, to), "bound_share": max(tb, to) / k,
                               "bytes": nbytes, "ops": ops}
        del planes, p32, grids, g_lv
    t["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    t["bound_share"] = t["bound_ms"] / t["ms"]
    return t


def remat_timing(dev, batches, update_ckpt: bool) -> dict:
    """The Sintel semi recipe's step (bf16, the fused lookup) from the same
    seed with and without per-iteration remat: step ms over
    TRAIN_STEPS_TIMED steps by CUDA events after TRAIN_STEPS_MAIN warm-up
    steps, and peak memory over the timed steps."""
    import torch

    from flow_supervisor_tpu_torch.config import ExperimentConfig, ModelCfg, TrainCfg
    from flow_supervisor_tpu_torch.training.loop import build_model, make_step
    from flow_supervisor_tpu_torch.training.optim import batchnorm_params, make_optimizer
    from flow_supervisor_tpu_torch.training.state import TrainState

    cfg = ExperimentConfig(ModelCfg(**RECIPE_MODEL, compute_dtype="bfloat16"),
                           TrainCfg(**RECIPE_TRAIN, seed=7))
    model = build_model(cfg, torch.Generator().manual_seed(7), update_ckpt=update_ckpt).to(dev)
    state = TrainState.create(dict(model.named_parameters()),
                              make_optimizer(cfg.train, batchnorm_params(model)))
    step = make_step(model, cfg)
    dev_batches = [to_device(b, dev) for b in batches]
    for i in range(TRAIN_STEPS_MAIN):
        state, log = step(state, dev_batches[i % len(dev_batches)])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(TRAIN_STEPS_TIMED):
        state, log = step(state, dev_batches[i % len(dev_batches)])
    end.record()
    end.synchronize()
    log = {k: float(v) for k, v in log.items()}
    if not all(math.isfinite(v) for v in log.values()):
        raise AssertionError(f"remat={update_ckpt} semi step: non-finite log {log}")
    res = {"update_ckpt": update_ckpt, "timed_steps": TRAIN_STEPS_TIMED,
           "step_ms": start.elapsed_time(end) / TRAIN_STEPS_TIMED,
           "peak_mem_bytes": torch.cuda.max_memory_allocated(), "last_log": log}
    del model, state, dev_batches
    torch.cuda.empty_cache()
    return res


def phase_train_rest(dev, semi_res):
    """The rest of training: K12 against its plain version (``k12_checks``);
    one fp32 semi step through plane and through pallas on the card against
    the same step on the CPU (phase 5's limits); the Sintel semi recipe's
    step at full width through plane and pallas (``train_main``: the main
    path's launch counts over two steps, five timed steps, peak memory,
    device time; K12 timed on its lookups) beside the fused one of
    train_main (``semi_res``, on the same batches); the fused
    step with and without per-iteration remat (``remat_timing``), and one
    fp32 step's gradients with remat against those without it at phase 5's
    limits; data parallelism on the card (``parallel.dryrun``): a world of 1
    over NCCL (the plane lookup and no cuDNN: nothing sums in an order that
    changes from run to run) equal to the
    one-process step bit for bit, a world of 2 over gloo on the one card
    (the semi step with the teacher SMURF loss, the Unsup step, and the
    chairs Baseline with unfrozen batch norm) against one process on the
    global batch within ``dryrun.LIMITS``, and the chairs Baseline's world of
    2 with cuDNN's convs on both sides, the one-card training path, within
    ``dryrun.CUDNN_GRAD_REL``. Returns (the plane step's main-path launch counts,
    K12's times, K12's largest error)."""
    import dataclasses

    import torch

    from flow_supervisor_tpu_torch.parallel import dryrun

    t_phase = time.perf_counter()
    rows, k12_err = k12_checks(dev)
    emit({"phase": "train_rest", "ok": True, "k12_checks": rows, "max_abs_err": k12_err})

    def backend_cfg(cfg, backend):
        return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                                  lookup_backend=backend))

    cpu = torch.device("cpu")
    cfg, weights, batch = step_parity_setup("semi")
    for backend in ("plane", "pallas"):
        bcfg = backend_cfg(cfg, backend)
        ref = step_outputs(bcfg, weights, batch, cpu)
        run = step_outputs(bcfg, weights, batch, dev)
        err = parity_errors(run, ref, cfg.train.lr)
        res = {"phase": "train_rest", "check": "card_vs_cpu_step", "lookup_backend": backend,
               "step": "semi", "crop_hw": [64, 96], "full_hw": [96, 128],
               "iters": PARITY_ITERS, "dtype": "float32", "logs_cpu": ref[0],
               "logs_gpu": run[0], **err, "ok": parity_ok(err)}
        emit(res)
        if not res["ok"]:
            raise AssertionError(f"semi step through {backend}: card-vs-CPU parity failed: {res}")

    gen = torch.Generator().manual_seed(7)
    batches = [recipe_batches(TRAIN_SUP, TRAIN_UNSUP, TRAIN_FULL, gen, (16, 152), (32, 128)),
               recipe_batches(TRAIN_SUP, TRAIN_UNSUP, TRAIN_FULL, gen, (24, 296), (56, 256))]
    shapes = dict(batch=1, sup_hw=TRAIN_SUP, unsup_hw=TRAIN_UNSUP, full_hw=TRAIN_FULL,
                  teacher_iters=ITERS)
    plane_got = k12_times = None
    for kind, backend, g_dtype in (("semi_plane", "plane", torch.bfloat16),
                                   ("semi_pallas", "pallas", torch.float32)):
        got, model, dev_batches, res = train_main(dev, kind, batches, **shapes)
        res.update(phase="train_rest", lookup_backend=backend,
                   k12=k12_timing(model, dev_batches[0], dev, g_dtype))
        res["k12"]["launches"] = got["corr_plane_bwd"]
        res["fused_step_of_train_main"] = {k: semi_res[k] for k in (
            "step_ms", "peak_mem_bytes", "device_ms_per_step", "device_idle_share",
            "launches_per_step_all", "by_category_ms_per_step")}
        if kind == "semi_plane":
            plane_got, k12_times = got, res["k12"]
        emit(res)
        del model, dev_batches
        torch.cuda.empty_cache()

    remat = [remat_timing(dev, batches, flag) for flag in (False, True)]
    a = step_outputs(cfg, weights, batch, dev)
    again = step_outputs(cfg, weights, batch, dev)
    b = step_outputs(cfg, weights, batch, dev, update_ckpt=True)
    err = parity_errors(b, a, cfg.train.lr)
    spread = parity_errors(again, a, cfg.train.lr)
    res = {"phase": "train_rest", "check": "remat", "step": "semi sintel (train.sh), fused",
           "dtype": "bfloat16", "runs": remat,
           "peak_mem_ratio": remat[1]["peak_mem_bytes"] / remat[0]["peak_mem_bytes"],
           "step_ms_ratio": remat[1]["step_ms"] / remat[0]["step_ms"],
           "fp32_grads_remat_vs_plain": err, "fp32_grads_plain_vs_plain": spread,
           "ok": parity_ok(err)}
    emit(res)
    if not res["ok"]:
        raise AssertionError(f"remat step gradients: {res}")

    one = dryrun.run_dryrun(1, ("baseline",), "cuda", backend="nccl", lookup_backend="plane")
    two = dryrun.run_dryrun(2, ("semi", "unsup", "baseline"), "cuda", backend="gloo")
    two_cudnn = dryrun.run_dryrun(2, ("baseline",), "cuda", backend="gloo", cudnn=True)
    res = {"phase": "train_rest", "check": "data_parallel", "world_1_nccl": one,
           "world_2_gloo": two, "world_2_gloo_cudnn": two_cudnn,
           "ok": all(e["bit_for_bit"] for e in one.values())
           and all(e["ok"] for e in (*two.values(), *two_cudnn.values()))}
    emit(res)
    if not res["ok"]:
        raise AssertionError(f"data parallelism on the card: {res}")
    emit({"phase": "train_rest", "ok": True, "seconds": time.perf_counter() - t_phase})
    return plane_got, {"corr_plane_bwd": k12_times}, k12_err


def metrics_rows(run: str) -> list:
    with open(os.path.join(run, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def cli_run(where: str, argv: list, want_steps: dict, train_steps: list, val_steps: list,
            ckpt_steps: list) -> dict:
    """``python -m flow_supervisor_tpu_torch.train`` in this process on the
    card, with the launch counters reset: every kernel of ``want_steps``
    (kernel -> launches per step) launched at least that often per step of
    this run, no other kernel but the validation's K6 and encoder kernels;
    the run's metrics rows (train and val steps, every loss finite) and
    checkpoint steps as listed. Returns the run's summary."""
    import torch

    from flow_supervisor_tpu_torch.train import main as train_cli
    from flow_supervisor_tpu_torch.training import checkpoint as ckpt

    run = argv[0]
    before = len(metrics_rows(run)) if os.path.exists(os.path.join(run, "metrics.jsonl")) else 0
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    rc = train_cli(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got = launch_counts()
    if rc != 0:
        raise AssertionError(f"{where}: the train CLI exited {rc}")
    rows = metrics_rows(run)[before:]
    steps = len(train_steps)
    allowed = set(want_steps) | {"corr_fused_all", "conv3x3_stats", "norm_stats", "norm_apply"}
    short = {k: (got[k], steps * n) for k, n in want_steps.items() if got[k] < steps * n}
    stray = {k: v for k, v in got.items() if v and k not in allowed}
    if short or stray:
        raise AssertionError(f"{where}: launches {got}: short {short}, not on the path {stray}")
    check_tc_launches(where, got["conv3x3_stats"])
    check_vector_launches(where, got["norm_stats"] + got["norm_apply"])
    train_rows = [r for r in rows if r["prefix"] == "train"]
    if ([r["step"] for r in train_rows] != train_steps
            or [r["step"] for r in rows if r["prefix"] == "val"] != val_steps
            or not all(math.isfinite(v) for r in rows for v in r.values() if isinstance(v, float))):
        raise AssertionError(f"{where}: bad metrics rows {rows}")
    if ckpt.checkpoint_steps(run) != ckpt_steps:
        raise AssertionError(f"{where}: checkpoints {ckpt.checkpoint_steps(run)} != {ckpt_steps}")
    last = ckpt.restore_checkpoint(run, map_location="cpu")
    if last["opt_state"] is None or last["opt_state"].count != ckpt_steps[-1]:
        raise AssertionError(f"{where}: optimizer count at step {last['step']} is "
                             f"{last['opt_state'] and last['opt_state'].count}")
    rates = [r["steps_per_sec"] for r in train_rows[1:]]  # the first holds the warm-up
    return {"seconds": seconds, "launches": got, "train_steps": train_steps,
            "val_steps": val_steps, "checkpoints": ckpt_steps,
            "optimizer_count": last["opt_state"].count,
            "last_train_row": {k: v for k, v in train_rows[-1].items() if k != "prefix"},
            "cli_steps_per_s_median": sorted(rates)[len(rates) // 2] if rates else None}


def loader_rate(train_cfg, workers: int) -> dict:
    """``fetch_dataloader`` alone: batches/s over LOADER_TIMED batches after
    LOADER_WARM, by the host clock."""
    import dataclasses

    from flow_supervisor_tpu_torch.data.pipeline import fetch_dataloader

    loader = fetch_dataloader(dataclasses.replace(train_cfg, loader_workers=workers))
    try:
        for _ in range(LOADER_WARM):
            next(loader)
        t0 = time.perf_counter()
        for _ in range(LOADER_TIMED):
            next(loader)
        seconds = time.perf_counter() - t0
    finally:
        loader.close()
    return {"loader_workers": workers, "batches": LOADER_TIMED, "seconds": seconds,
            "batches_per_s": LOADER_TIMED / seconds}


def phase_train_data(dev, in_memory: dict):
    """The training-data path at real sizes: a dataset tree written by the
    port's data/synthetic.py, then through the train CLI (on the card, the
    auto lookup: fused) (a) the chairs Baseline stage, B=10, 2 steps, which
    saves a checkpoint; (b) the Sintel semi recipe from it by
    --pretrained_ckpt, 6 steps with checkpoints at 3 and 6 and standing
    validation (one record a set); (c) the same command to 8 steps, which
    resumes at 6 with the optimizer state (its count 6, then 8). Then, for
    the semi recipe: the loader alone (batches/s with 0 and 4 workers), and
    steps/s of the composed step (the next batch from the loader, then the
    step; 4 workers, then serial) against in-memory batches of the same
    recipe, all by the host clock in this phase, beside train_main's
    in-memory rate (CUDA events), and the device idle share of composed
    steps with 4 workers (torch.profiler)."""
    import dataclasses

    import torch

    from flow_supervisor_tpu_torch.config import ExperimentConfig
    from flow_supervisor_tpu_torch.data.pipeline import fetch_dataloader
    from flow_supervisor_tpu_torch.data.synthetic import build_synthetic_tree
    from flow_supervisor_tpu_torch.profile_forward import profile
    from flow_supervisor_tpu_torch.training import checkpoint as ckpt
    from flow_supervisor_tpu_torch.training.loop import _to, build_model, make_step
    from flow_supervisor_tpu_torch.training.optim import batchnorm_params, make_optimizer
    from flow_supervisor_tpu_torch.training.state import TrainState

    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "datasets")
        t0 = time.perf_counter()
        build_synthetic_tree(root, sizes=TRAIN_DATA_SIZES, chairs_pairs=TRAIN_DATA_CHAIRS_PAIRS)
        emit({"phase": "train_data", "tree_seconds": time.perf_counter() - t0,
              "sizes": {k: list(v) for k, v in TRAIN_DATA_SIZES.items()},
              "chairs_pairs": TRAIN_DATA_CHAIRS_PAIRS})
        chairs, semi = os.path.join(tmp, "chairs"), os.path.join(tmp, "semi")
        semi_argv = [semi] + SEMI_FLAGS + [
            "--pretrained_ckpt", chairs, "--num_steps", str(SEMI_STEPS), "--val_step",
            str(SEMI_VAL_STEP), "--val_max_records", "1", "--log_every", "1",
            "--loader_workers", "4"]
        with data_root(root):
            runs = {"chairs": cli_run(
                "train_data chairs", [chairs] + CHAIRS_FLAGS + [
                    "--num_steps", str(CHAIRS_STEPS), "--val_max_records", "1", "--log_every", "1"],
                STEP_LAUNCHES["baseline"], [1, 2], [0, 2], [CHAIRS_STEPS])}
            runs["semi"] = cli_run("train_data semi", semi_argv, TRAIN_LAUNCHES,
                                   list(range(1, SEMI_STEPS + 1)), [0, 3, 6], [3, 6])
            at_resume = ckpt.restore_checkpoint(semi, map_location="cpu")
            if at_resume["step"] != SEMI_STEPS or at_resume["opt_state"].count != SEMI_STEPS:
                raise AssertionError(f"train_data: the checkpoint to resume from is step "
                                     f"{at_resume['step']}, count {at_resume['opt_state'].count}")
            runs["resume"] = cli_run(
                "train_data resume", semi_argv[:semi_argv.index("--num_steps")] + [
                    "--num_steps", str(RESUME_STEPS)] + semi_argv[semi_argv.index("--num_steps") + 2:],
                TRAIN_LAUNCHES, [7, 8], [8], [3, 6, 8])
            # steps 7 and 8 alone took the count from 6 to 8: the resume restored it
            runs["resume"]["resumed_from"] = {"step": at_resume["step"],
                                              "optimizer_count": at_resume["opt_state"].count}
            for name, res in runs.items():
                emit({"phase": "train_data", "run": name, **res})

            cfg = ExperimentConfig.load_yaml(semi)
            rates = [loader_rate(cfg.train, w) for w in (0, 4)]
            emit({"phase": "train_data", "loader_alone": rates,
                  "stage": cfg.train.stage, "batch_size": cfg.train.batch_size})

            # composed steps (loader + step) against in-memory batches, from
            # the resumed run's weights and optimizer state
            model = build_model(cfg)
            last = ckpt.restore_checkpoint(semi, map_location="cpu")
            model.load_state_dict(last["model"])
            model.to(dev)
            state = TrainState.create(dict(model.named_parameters()),
                                      make_optimizer(cfg.train, batchnorm_params(model)))
            state.step, state.opt_state = last["step"], ckpt.optimizer_state_to(last["opt_state"], dev)
            step = make_step(model, cfg)
            holder = {"state": state, "i": 0}

            def rate(fn):
                for _ in range(COMPOSED_WARM):
                    fn()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(COMPOSED_TIMED):
                    log = fn()
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                if not all(math.isfinite(float(v)) for v in log.values()):
                    raise AssertionError(f"train_data: non-finite log {log}")
                return COMPOSED_TIMED / seconds

            composed_rates, fixed, prof = {}, None, None
            for workers in (cfg.train.loader_workers, 0):  # the recipe's 4, then serial
                loader = fetch_dataloader(dataclasses.replace(cfg.train, loader_workers=workers))
                try:
                    if fixed is None:
                        fixed = [tuple(_to(b, dev) for b in next(loader)) for _ in range(2)]

                    def composed():
                        batch = tuple(_to(b, dev) for b in next(loader))
                        holder["state"], log = step(holder["state"], batch)
                        return log

                    composed_rates[workers] = rate(composed)
                    if prof is None:
                        prof = profile(composed, n=COMPOSED_PROFILED)
                finally:
                    loader.close()

            def in_memory_step():
                holder["state"], log = step(holder["state"], fixed[holder["i"] % 2])
                holder["i"] += 1
                return log

            mem_rate = rate(in_memory_step)
        comp_rate = composed_rates[cfg.train.loader_workers]
        emit({"phase": "train_data", "ok": True, "recipe": "semi sintel (train.sh)",
              "loader_workers": cfg.train.loader_workers, "timed_steps": COMPOSED_TIMED,
              "composed_steps_per_s": comp_rate,
              "composed_steps_per_s_by_workers": {str(k): v for k, v in composed_rates.items()},
              "in_memory_steps_per_s": mem_rate,
              "train_main_in_memory_steps_per_s": in_memory.get("steps_per_s"),
              "composed_over_in_memory": comp_rate / mem_rate,
              "composed_device_idle_share": prof.get("device_idle_share"),
              "composed_device_ms_per_step": prof.get("device_ms_per_forward"),
              "composed_launches_per_step": prof.get("launches_per_forward"),
              "profiled_steps": COMPOSED_PROFILED})


def set_gamma(model, value: float = GMA_GAMMA) -> None:
    """Every GMA aggregator's gamma (the student's and the teacher's) to value."""
    import torch

    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("aggregator.gamma"):
                p.fill_(value)


def model_forward(dev, kind: str, backend: str, gen):
    """One 448x1024 B=1 bf16 forward of kind ("gma" or "small") under
    backend with the launch counters reset, which must launch each kernel the
    expected number of times (GMA: RAFT's encoder kernels and 12 lookups;
    small: 21 K3 + K4 and 12 lookups at radius 3, no K2), on the tensor-core
    and vector bodies; then fwd ms over back-to-back forwards, peak memory,
    device time and idle share of one forward, and for GMA the device ms of
    the attention map (once a forward) and of one aggregation (12 a
    forward). Returns (launch counts, the result line)."""
    import torch

    from flow_supervisor_tpu_torch.models.raft import RAFT, RAFTConfig
    from flow_supervisor_tpu_torch.profile_forward import profile

    bf16 = torch.bfloat16
    model = RAFT(RAFTConfig(iters=ITERS, dtype=bf16, corr_dtype=bf16, lookup_backend=backend,
                            **MODEL_KINDS[kind]), generator=gen).to(dev)
    set_gamma(model)
    img1, img2 = (t.to(dev) for t in synthetic_pair(1, *MAIN_HW, gen))

    def forward():
        return model(img1, img2, final_flow_only=True)

    forward()
    torch.cuda.synchronize()
    reset_launch_counts()
    out = forward()
    torch.cuda.synchronize()
    got = launch_counts()
    want = {k: 0 for k in SOURCES}
    want.update(SMALL_ENCODER_LAUNCHES if kind == "small" else ENCODER_LAUNCHES)
    want[LOOKUP_KERNEL[(backend, 1)]] = ITERS
    flow = out["flow_up"]
    where = f"gma_small {kind} {backend} B=1"
    if tuple(flow.shape) != (1, 1, *MAIN_HW, 2) or not torch.isfinite(flow).all():
        raise AssertionError(f"{where}: output bad, shape {tuple(flow.shape)}")
    if got != want:
        raise AssertionError(f"{where}: launch counts {got} != expected {want}")
    tc = check_tc_launches(where, want["conv3x3_stats"])
    check_vector_launches(where, want["norm_stats"] + want["norm_apply"])
    del out, flow
    torch.cuda.reset_peak_memory_stats()
    fwd_ms = time_ms(forward, reps=10, warm=2)
    peak = torch.cuda.max_memory_allocated()
    prof = profile(forward, n=1)
    res = {"phase": "gma_small", "ok": True, "model": kind, "lookup_backend": backend, "batch": 1,
           "hw": list(MAIN_HW), "iters": ITERS, "dtype": "bfloat16",
           "radius": model.cfg.corr_radius, "launches": got, "conv_tensor_core_launches": tc,
           "fwd_ms": fwd_ms, "pairs_per_s": 1000.0 / fwd_ms, "peak_mem_bytes": peak,
           "device_ms_per_forward": prof.get("device_ms_per_forward"),
           "device_idle_share": prof.get("device_idle_share"),
           "launches_per_forward_all": prof.get("launches_per_forward"),
           "by_category_ms_per_forward": prof.get("by_category_ms_per_forward")}
    if kind == "gma":
        with torch.no_grad():
            _, inp = model.context(img1)
            attn = model.attention_map(inp)
            h8, w8 = MAIN_HW[0] // 8, MAIN_HW[1] // 8
            motion = torch.randn(1, 128, h8, w8, generator=gen).to(dev, bf16).contiguous(
                memory_format=torch.channels_last)
            att_ms = time_ms(lambda: model.attention_map(inp), reps=10, device_only=True)
            agg_ms = time_ms(lambda: model.update_block.aggregator(attn, motion), reps=10,
                             device_only=True)
        res.update(attention_map_shape=list(attn.shape), attention_ms=att_ms,
                   aggregation_ms_per_call=agg_ms, aggregation_ms_per_forward=ITERS * agg_ms)
    del model, img1, img2
    torch.cuda.empty_cache()
    return got, res


def phase_gma_small(dev):
    """The GMA and small models on the card: K6-K9 at radius 3 against their
    plain versions (tile and per-query paths, fp32 and bf16); card-vs-CPU
    fp32 parity of each model's 216x512, 12-iteration forward under fused
    and plane (GMA also at 2 heads with the position and content similarity,
    fused); each model's 448x1024 B=1 bf16 forward under fused and plane
    (``model_forward``); the GMA DAVIS recipe's semi step and the small
    model's chairs Baseline step through ``training.loop.train``
    (``train_main``), with K8 / K9 timed at radius 3 on the small step's
    lookup inputs; the train CLI for gma-semi on a tiny synthetic tree, 2
    steps, then a resume to 3. Returns (launches, times, errs) for the
    kernel line: the launches at radius 3 by kernel, their K8 / K9 times,
    and the largest bf16 error of each of K6-K9 at radius 3."""
    import torch

    from flow_supervisor_tpu_torch.data.synthetic import build_synthetic_tree
    from flow_supervisor_tpu_torch.models.raft import RAFT, RAFTConfig
    from flow_supervisor_tpu_torch.training import checkpoint as ckpt

    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(9)
    checks, errs = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        e = k6_k7_checks(dev, dtype, gen, checks, SMALL_RADIUS, R3_K6_K7_CASES)
        e["bwd_df1"] = k8_checks(dev, dtype, gen, checks, SMALL_RADIUS, R3_BWD_CASES)
        e["bwd_df2"] = k9_checks(dev, dtype, gen, checks, SMALL_RADIUS, R3_BWD_CASES)
        if dtype == torch.bfloat16:
            errs = e
    torch.cuda.synchronize()
    emit({"phase": "gma_small", "ok": True, "radius": SMALL_RADIUS, "kernel_checks": checks})

    img1, img2 = synthetic_pair(1, 216, 512, gen)
    for name, kw, backends in (("gma", MODEL_KINDS["gma"], ("fused", "plane")),
                               ("gma_2heads_position_and_content",
                                dict(gma=True, num_heads=2, position_and_content=True), ("fused",)),
                               ("small", MODEL_KINDS["small"], ("fused", "plane"))):
        base = RAFT(RAFTConfig(iters=ITERS, **kw), generator=gen)
        set_gamma(base)
        for backend in backends:
            model = RAFT(RAFTConfig(iters=ITERS, lookup_backend=backend, **kw))
            model.load_state_dict(base.state_dict())
            cpu = model(img1, img2, final_flow_only=True)["flow_up"][-1]
            model.to(dev)
            gpu = model(img1.to(dev), img2.to(dev), final_flow_only=True)["flow_up"][-1].cpu()
            d = (gpu - cpu).abs()
            res = {"phase": "gma_small", "parity": name, "lookup_backend": backend,
                   "hw": [216, 512], "iters": ITERS, "dtype": "float32",
                   "radius": model.cfg.corr_radius, "mean_abs_diff_px": float(d.mean()),
                   "max_abs_diff_px": float(d.max()), "max_abs_flow_px": float(cpu.abs().max())}
            res["ok"] = bool(torch.isfinite(gpu).all() and res["mean_abs_diff_px"] < 1e-3
                             and res["max_abs_diff_px"] < 2e-2)
            emit(res)
            if not res["ok"]:
                raise AssertionError(f"gma_small parity failed: {res}")
            del model

    launches = {}
    for kind in MODEL_KINDS:
        for backend in ("fused", "plane"):
            got, res = model_forward(dev, kind, backend, gen)
            launches[(kind, backend)] = got
            emit(res)

    gma_batches = [recipe_batches(GMA_CROP, GMA_CROP, GMA_FULL, gen, (16, 40), (56, 80)),
                   recipe_batches(GMA_CROP, GMA_CROP, GMA_FULL, gen, (64, 88), (0, 8))]
    got, model, _, res = train_main(dev, "gma_semi", gma_batches, batch=1, sup_hw=GMA_CROP,
                                    unsup_hw=GMA_CROP, full_hw=GMA_FULL, teacher_iters=ITERS)
    emit(res)
    del model
    torch.cuda.empty_cache()
    chairs = [labeled_batch(CHAIRS_BATCH, CHAIRS_HW, gen) for _ in range(2)]
    got, model, dev_batches, res = train_main(dev, "small_baseline", chairs,
                                              batch=CHAIRS_BATCH, hw=CHAIRS_HW)
    launches["small_baseline"] = got
    times = train_bwd_timing(model, [("chairs", dev_batches[0], "baseline", ITERS)], dev,
                             radius=SMALL_RADIUS)
    res.update(radius=model.cfg.corr_radius, bwd_kernels=times)
    emit(res)
    del model, dev_batches
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "datasets")
        build_synthetic_tree(root)
        run = os.path.join(tmp, "gma")
        with data_root(root):
            cli = cli_run("gma_small cli", [run] + GMA_CLI_FLAGS + ["--num_steps", "2"],
                          TRAIN_LAUNCHES, [1, 2], [0, 2], [2])
            if "att.to_qk.weight" not in ckpt.restore_checkpoint(run, map_location="cpu")["model"]:
                raise AssertionError("gma_small cli: the checkpoint holds no GMA attention")
            resume = cli_run("gma_small cli resume", [run, "--num_steps", "3"], TRAIN_LAUNCHES,
                             [3], [3], [2, 3])
        emit({"phase": "gma_small", "ok": True, "cli": "gma-semi semi-davis_unsup-ctskh",
              "run": cli, "resume": resume})
    emit({"phase": "gma_small", "ok": True, "seconds": time.perf_counter() - t0})
    r3 = {"corr_plane": launches[("small", "plane")]["corr_plane"],
          "corr_fused_all": launches[("small", "fused")]["corr_fused_all"],
          **{k: launches["small_baseline"][k] for k in ("corr_fused_level", "bwd_df1", "bwd_df2")}}
    return r3, times, errs


def native_read_times(d: str) -> dict:
    """Host ms a file of the native .flo / .ppm / .pfm readers, one file a
    call and (.flo, .ppm) the threaded batch reader, against the numpy
    readers on the same files (best of 3 passes); raises if any output
    differs from the numpy reader's."""
    import numpy as np

    from flow_supervisor_tpu_torch.data import io as pio
    from flow_supervisor_tpu_torch.data import native

    rng = np.random.default_rng(22)
    kinds = (
        ("flo", (436, 1024), lambda p: pio.write_flo(p, rng.normal(0, 5, (436, 1024, 2)).astype(
            np.float32)), pio.read_flo_plain, native.read_flo, native.read_flo_batch),
        ("ppm", (384, 512), lambda p: pio.write_ppm(p, rng.integers(0, 256, (384, 512, 3), np.uint8)),
         lambda p: pio.read_ppm(p).astype(np.float32) / np.float32(255.0), native.read_ppm,
         native.read_ppm_batch),
        ("pfm", (540, 960), lambda p: pio.write_pfm(p, rng.normal(0, 5, (540, 960, 3)).astype(
            np.float32)), pio.read_pfm_plain, native.read_pfm, None),
    )
    out = {}
    for kind, (h, w), write, plain, read, batch in kinds:
        paths = [os.path.join(d, f"{i}.{kind}") for i in range(ENTRY_READ_FILES)]
        for p in paths:
            write(p)
        want = np.stack([plain(p) for p in paths])
        if not np.array_equal(np.stack([read(p) for p in paths]), want):
            raise AssertionError(f"entry: the native .{kind} reader differs from numpy's")
        row = {"hw": [h, w], "files": len(paths)}
        for name, fn in (("numpy", lambda: [plain(p) for p in paths]),
                         ("native", lambda: [read(p) for p in paths])):
            row[f"{name}_ms_per_file"] = 1e3 * min(timed(fn) for _ in range(3)) / len(paths)
        if batch is not None:
            if not np.array_equal(batch(paths, h, w, ENTRY_READ_THREADS), want):
                raise AssertionError(f"entry: the native .{kind} batch reader differs from numpy's")
            row["batch_ms_per_file"] = 1e3 * min(
                timed(lambda: batch(paths, h, w, ENTRY_READ_THREADS)) for _ in range(3)) / len(paths)
            row["batch_threads"] = ENTRY_READ_THREADS
        out[kind] = row
    return out


def phase_entry(dev):
    """The entry points on the card, as a user runs them: a DAVIS directory
    of 480x854 baseline JPEG frames (the port's encoder, quality 90) and a
    Sintel tree at 436x1024 (``write_eval_tree``), a gma-semi checkpoint
    directory (``args.yaml`` and ``ckpt_1.pt``; every gamma 0.5, fp32, the
    auto lookup). ``extract_flow`` over the frames at 12 iterations (after a
    warm-up run) with the launch counters reset: K6 12 times a pair and
    K2-K4 their encoder counts, two ``.flo`` files and two ``vis`` PNGs, the
    first flow equal to ``Evaluator.predict`` on the same decoded frames, host
    ms a pair by decode, forward and write, device ms and idle share of a
    pair. ``evaluate`` on the Sintel tree at 12 iterations (and the
    checkpoint's 12 teacher iterations) with the counters reset, equal to
    the ``Evaluator`` in this process within 1e-6, and device ms and idle
    share of a pair with the teacher split; ``ckpt_tool list`` and
    ``clean``, and the cleaned directory evaluates to the same numbers. The
    JPEG round trip of each frame (PSNR at least 38 dB) and decode ms a
    frame (host clock)."""
    import io

    import numpy as np
    import torch

    from flow_supervisor_tpu_torch import ckpt_tool, evaluate, extract_flow
    from flow_supervisor_tpu_torch.config import ExperimentConfig, ModelCfg
    from flow_supervisor_tpu_torch.data import datasets as D
    from flow_supervisor_tpu_torch.data import native
    from flow_supervisor_tpu_torch.data.io import read_flo, read_image, read_png, write_jpeg
    from flow_supervisor_tpu_torch.data.pipeline import load_record
    from flow_supervisor_tpu_torch.evaluation import Evaluator
    from flow_supervisor_tpu_torch.profile_forward import profile
    from flow_supervisor_tpu_torch.training import checkpoint as ckpt
    from flow_supervisor_tpu_torch.training.loop import build_model

    t_phase = time.perf_counter()
    gen = torch.Generator().manual_seed(21)

    def cli(main, argv) -> str:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = main(argv)
        if rc != 0:
            raise AssertionError(f"entry: {main.__module__} {argv} exited {rc}")
        return out.getvalue()

    def metrics(res: dict) -> dict:
        return {k: v for k, v in res.items()
                if not k.endswith(("pairs_per_sec", "_ms_per_pair"))}

    def same(where, got: dict, want: dict) -> float:
        got, want = metrics(got), metrics(want)
        if set(got) != set(want) or not want:
            raise AssertionError(f"{where}: keys {sorted(got)} != {sorted(want)}")
        diff = max(abs(got[k] - want[k]) for k in want)
        if not diff <= ENTRY_EXACT:
            raise AssertionError(f"{where}: differs by {diff}: {got} vs {want}")
        return diff

    with tempfile.TemporaryDirectory() as tmp:
        davis = os.path.join(tmp, "DAVIS/JPEGImages/480p/bear")
        os.makedirs(davis)
        frames = eval_frames(ENTRY_FRAMES, *ENTRY_DAVIS_HW, gen)
        jpeg = []
        for i, frame in enumerate(frames):
            path = os.path.join(davis, f"{i:05d}.jpg")
            t0 = time.perf_counter()
            write_jpeg(path, frame, ENTRY_JPEG_QUALITY)
            enc_s = time.perf_counter() - t0
            back = native.read_jpeg(path)
            mse = float(((back.astype(np.float64) - frame) ** 2).mean())
            psnr = 10 * math.log10(255.0 ** 2 / max(mse, 1e-12))
            dec_ms = 1e3 * min(timed(lambda: native.read_jpeg(path)) for _ in range(5))
            jpeg.append({"file": os.path.basename(path), "bytes": os.path.getsize(path),
                         "psnr_db": psnr, "mean_abs_err": float(np.abs(
                             back.astype(np.int32) - frame).mean()),
                         "encode_s": enc_s, "decode_ms": dec_ms})
            if back.shape != frame.shape or psnr < ENTRY_ROUND_TRIP_PSNR_DB:
                raise AssertionError(f"entry: JPEG round trip of {path}: {jpeg[-1]}")
        emit({"phase": "entry", "ok": True, "jpeg": jpeg, "quality": ENTRY_JPEG_QUALITY,
              "hw": list(ENTRY_DAVIS_HW), "decode_ms_per_frame": min(j["decode_ms"] for j in jpeg),
              "clock": "host"})
        reads = os.path.join(tmp, "reads")
        os.makedirs(reads)
        emit({"phase": "entry", "ok": True, "native_reads": native_read_times(reads),
              "clock": "host"})

        run = os.path.join(tmp, "gma_semi")
        cfg = ExperimentConfig(ModelCfg(model_type="gma-semi", iters=ENTRY_ITERS,
                                        teacher_iters=ENTRY_ITERS, compute_dtype="float32",
                                        lookup_backend="auto"), ckpt_dir=run)
        cfg.save_yaml()
        model = build_model(cfg, generator=gen)
        set_gamma(model)
        ckpt.save_checkpoint(run, 1, model.state_dict())
        del model

        # extract_flow: a warm-up run, then the main path with the counters reset
        cli(extract_flow.main, [run, "--source_dirs", davis, "--target_dirs",
                                os.path.join(tmp, "warm"), "--eval_iters", str(ENTRY_ITERS)])
        out = os.path.join(tmp, "extracted")
        torch.cuda.synchronize()
        reset_launch_counts()
        text = cli(extract_flow.main, [run, "--source_dirs", davis, "--target_dirs", out,
                                       "--eval_iters", str(ENTRY_ITERS)])
        torch.cuda.synchronize()
        pairs = ENTRY_FRAMES - 1
        per_pair = eval_launch_check("entry extract_flow", launch_counts(), pairs, ENTRY_ITERS, 0)
        summary = json.loads(text.strip().splitlines()[-1])["extract_flow"]
        names = sorted(os.listdir(davis))[:-1]
        flos = sorted(os.listdir(os.path.join(out, "flo")))
        vis = sorted(os.listdir(os.path.join(out, "vis")))
        if flos != [n + ".flo" for n in names] or vis != [n + "_flow.png" for n in names]:
            raise AssertionError(f"entry extract_flow wrote {flos} and {vis}")
        for n in vis:
            img = read_png(os.path.join(out, "vis", n))
            if img.shape != (*ENTRY_DAVIS_HW, 3) or img.dtype != np.uint8:
                raise AssertionError(f"entry extract_flow: {n} is {img.shape} {img.dtype}")
        flow = read_flo(os.path.join(out, "flo", flos[0]))
        model = extract_flow.load_model(run, device="cuda")
        ev = Evaluator(model, iters=ENTRY_ITERS, use_teacher=False)
        img1, img2 = (read_image(os.path.join(davis, n)) for n in sorted(os.listdir(davis))[:2])
        want = ev.predict(img1, img2, "sintel")[0]["student"][0]
        d_flow = float(np.abs(flow - want).max())
        if flow.shape != (*ENTRY_DAVIS_HW, 2) or not np.isfinite(flow).all() or d_flow > ENTRY_EXACT:
            raise AssertionError(f"entry extract_flow: the .flo differs from Evaluator.predict "
                                 f"by {d_flow} px (shape {flow.shape})")
        prof = profile(lambda: ev.predict(img1, img2, "sintel"), n=1)
        emit({"phase": "entry", "ok": True, "cli": "extract_flow", "model": "gma-semi (student)",
              "hw": list(ENTRY_DAVIS_HW), "pairs": pairs, "iters": ENTRY_ITERS,
              "dtype": "float32", "lookup_backend": "auto (fused)",
              "launches_per_pair": per_pair, "host": summary,
              "max_abs_diff_vs_predict_px": d_flow, "mean_abs_flow_px": float(np.abs(flow).mean()),
              "device_ms_per_pair": prof.get("device_ms_per_forward"),
              "device_idle_share": prof.get("device_idle_share"),
              "launches_per_pair_all": prof.get("launches_per_forward"),
              "by_category_ms_per_pair": prof.get("by_category_ms_per_forward")})
        del model, ev

        # evaluate on the Sintel tree, against the Evaluator in this process
        with data_root(os.path.join(tmp, "datasets")):
            write_eval_tree(os.path.join(tmp, "datasets"), gen, EVAL_SINTEL_HW, EVAL_PARITY_HW,
                            sintel_frames=3)
            argv = ["--dataset", "sintel", "--eval_iters", str(ENTRY_ITERS)]
            torch.cuda.synchronize()
            reset_launch_counts()
            got = json.loads(cli(evaluate.main, [run, *argv]))
            torch.cuda.synchronize()
            eval_pairs = sum(len(D.sintel(True, p)) for p in ("clean", "final"))
            eval_per_pair = eval_launch_check("entry evaluate", launch_counts(), eval_pairs,
                                              ENTRY_ITERS, ENTRY_ITERS)
            check_eval_result("entry evaluate", {k[len("clean_"):]: v for k, v in got.items()
                                                 if k.startswith("clean_")}, sparse=False)
            model, _ = evaluate.load_model(run, device="cuda")
            ev = Evaluator(model, iters=ENTRY_ITERS)
            want = {}
            for p in ("clean", "final"):
                want.update({f"{p}_{k}": v for k, v in ev.evaluate(D.sintel(True, p)).items()})
            d_eval = same("entry evaluate vs the Evaluator", got, want)
            img1, img2, _, _ = load_record(D.sintel(True, "clean")[0])
            eprof = profile(lambda: ev.predict(img1, img2, "sintel"), n=1)
            del model, ev

            listing = cli(ckpt_tool.main, ["list", run]).strip()
            if listing != "steps: [1]":
                raise AssertionError(f"entry ckpt_tool list: {listing!r}")
            clean = os.path.join(tmp, "gma_semi_clean")
            cli(ckpt_tool.main, ["clean", run, clean])
            restored = ckpt.restore_checkpoint(clean, map_location="cpu")
            if restored["opt_state"] is not None or ckpt.checkpoint_steps(clean) != [1]:
                raise AssertionError("entry ckpt_tool clean: not one optimizer-free checkpoint")
            cleaned = json.loads(cli(evaluate.main, [clean, *argv]))
            d_clean = same("entry evaluate of the cleaned directory", cleaned, got)
        emit({"phase": "entry", "ok": True, "cli": "evaluate", "model": "gma-semi",
              "dataset": "sintel", "hw": list(EVAL_SINTEL_HW), "pairs": eval_pairs,
              "iters": ENTRY_ITERS, "teacher_iters": ENTRY_ITERS, "dtype": "float32",
              "launches_per_pair": eval_per_pair, "metrics": got,
              "pairs_per_s": {p: got[f"{p}_pairs_per_sec"] for p in ("clean", "final")},
              "host_ms_per_pair": {p: {k: got[f"{p}_{k}_ms_per_pair"]
                                       for k in ("decode", "warm_start", "forward")}
                                   for p in ("clean", "final")},
              "device_ms_per_pair": eprof.get("device_ms_per_forward"),
              "device_idle_share": eprof.get("device_idle_share"),
              "launches_per_pair_all": eprof.get("launches_per_forward"),
              "by_category_ms_per_pair": eprof.get("by_category_ms_per_forward"),
              "max_abs_diff_vs_evaluator": d_eval, "ckpt_tool": listing,
              "max_abs_diff_cleaned": d_clean})
    emit({"phase": "entry", "ok": True, "seconds": time.perf_counter() - t_phase})


def main() -> int:
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from flow_supervisor_tpu_torch.kernels import _build

    smi = gpu_line()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # TF32 off: the fp32 comparisons need full fp32 convs and matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    from flow_supervisor_tpu_torch.data import native

    t0 = time.perf_counter()
    _build.lib()
    native.lib()
    emit({"phase": "build", "ok": True, "seconds": time.perf_counter() - t0,
          "nvcc_seconds": _build.build_seconds, "library": _build.library_path().name,
          "host_library_seconds": native.build_seconds,
          "host_library": native.library_path().name})

    errs = phase_kernels(dev)
    phase_parity(dev)
    launches, times = phase_main_path(dev)
    launches[("own", 1)], times[("own", 1)] = phase_own_paths(dev)
    phase_requests(dev)
    phase_evaluate(dev)
    phase_train_parity(dev)
    launches[("train", 1)], times[("train", 1)], semi_res = phase_train_main(dev)
    launches[("train_rest", 1)], times[("train_rest", 1)], errs["corr_plane_bwd"] = \
        phase_train_rest(dev, semi_res)
    r3_launches, r3_times, r3_errs = phase_gma_small(dev)
    phase_entry(dev)
    phase_train_data(dev, semi_res)

    kernels = []
    for name, (src, rep) in SOURCES.items():
        home = HOME_CONFIG[name]
        t = times[home][name]
        if home[0] == "train":
            config = {"train": "semi sintel recipe", "batch": 1, "steps": TRAIN_STEPS_MAIN,
                      "launches_per_step": TRAIN_LAUNCHES[name]}
        elif home[0] == "train_rest":
            config = {"train": "semi sintel recipe, plane lookup", "batch": 1,
                      "steps": TRAIN_STEPS_MAIN,
                      "launches_per_step": STEP_LAUNCHES["semi_plane"][name]}
        elif home[0] == "own":
            config = {"own_function": "conv3x3_fused" if name == "conv3x3_bare"
                      else "corr_pyramid_lookup_pallas", "hw": list(MAIN_HW)}
        else:
            config = {"lookup_backend": home[0], "batch": home[1]}
        entry = {
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[home][name], "max_abs_err": errs[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"], "config": config,
        }
        # radius 3, the small model's: launches in its main-path runs (K1 / K6
        # its B=1 forwards, K7-K9 its chairs Baseline step, two steps), the
        # largest bf16 error of phase 8's checks, K8 / K9's ms per step
        if name in r3_launches:
            entry["launches_radius_3"] = r3_launches[name]
        if name in r3_errs:
            entry["max_abs_err_radius_3"] = r3_errs[name]
        if name in r3_times:
            entry["ms_radius_3"] = r3_times[name]["ms"]
            entry["plain_ms_radius_3"] = r3_times[name]["plain_ms"]
            entry["bound_ms_radius_3"] = r3_times[name]["bound_ms"]
        kernels.append(entry)
    # K2 and K5 per fnet stage shape beside F.conv2d (bf16, device ms per call)
    emit({"conv_per_shape": [
        {"shape": shape, "cout": cout, "calls_per_forward": n, "conv3x3_stats_ms": k2[1],
         "conv3x3_bare_ms": k5[2], "library_ms": k2[3], "library_ms_k5_run": k5[4],
         "plain_ms": k2[2], "plain_ms_k5": k5[3]}
        for (shape, cout, n), k2, k5 in zip(CONV_SHAPES, times[("plane", 1)]["conv3x3_stats"]["per_call"],
                                           times[("own", 1)]["conv3x3_bare"]["per_call"])]})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
