#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (hold_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py [--phases 3,4,11]

Phases, in order; any failure ends the run with a non-zero exit.  Every
run trains the defaults, the proposal net on with its 1000-step warmup
(phase 11 cuts the warmup to reach proposal mode):

1. Environment: versions, the card's name and power limit, TF32 off.
2. Build: compile hold_tpu_torch/csrc/*.cu for sm_90a (nvcc, first use),
   and the meshing's hold_tpu_torch/meshing/csrc/mise.cpp (g++).
3. Kernel checks: each hand-written kernel against its plain PyTorch
   version on the card, at the shapes one full-width training step gives
   it, with the tolerance stated; kernel and plain times from CUDA events
   over enough launches to fill 100 ms.  Rows 2-3's backward must give the
   same tensors bit for bit call after call and equal the plain PyTorch
   repetition of their summation order bit for bit; they are timed by
   device time (torch.profiler) beside the wrapper's.  Row 4 runs on four
   buffers, the last the object's mesh state as meshing makes it from these
   parameters, against the object's own canonical points.  The fused
   query's four forms run
   again at shapes that are no multiple of its 128-point tile, and the hand's
   on one frame alone.  The fused training shade (row 7)
   runs forward and backward at the grad stage's real canonical points and
   J^-1 of both nodes (10 frames x 12,544 points) and at an N that is no
   multiple of its tile; its backward's time by kernel (torch.profiler); its
   backward part by part (each matrix and bias
   of the packs, the rows where its work divides), beside the plain version
   with float64 products and without its bf16 roundings, under the JAX
   package's test loss, under seeded cotangents, and under those with only
   the rows where its work divides carrying them.  The render
   kernels run at one render chunk's shapes (4096 rays x 98 samples of the
   eval sampler: a frame's hand and object pixels, then background ones),
   the KNN blend kernels at the sampler warp's.  Then the shapes ``-f``
   gives rows 5-6 (10 frames x 8 rays, the sampler at 16 / 32 / 8 samples,
   2 rounds): every fused query call of one ``-f`` sampler stage against its
   plain version and the layer-by-layer query; and row 7, forward and
   backward part by part, at what one ``-f`` grad stage hands it (10 frames
   x 208 points, both nodes), under the limits derived at that N.  Rows
   5-6 and 12-13 also with the relu trunk (``relu=True``) against the plain
   relu versions, the softplus plain version a control that must fail;
   rows 1 and 5 on every 4th MANO vertex in that set's tile order.  Then
   the JAX bench's step shapes (5,120, 10,240 and 20,480 rays): row 7 part
   by part at what each node's grad stage hands it there (N = 50,176,
   100,352 and 200,704 a frame) under the limits derived at each N, the
   plain versions on the call's first frames, the kernels on the whole call
   giving those frames' outputs bit for bit; at 20,480 rays rows 1-6 on
   the whole call against their plain versions on its first frames.  Last,
   the error-bound sampler's kernels (``csrc/error_bound.cu``, no TPU
   counterpart) on every round of one sampler stage at the render chunk
   (4,096 rays, the grid) and at 20,480 rays (a generator), each call
   against the plain steps at its own inputs and timed beside them.
4. Agreement on a small batch: the sdf the card's sampler read (every call
   of the fused query kernels, at its own inputs) against the plain
   versions on the CPU at the same inputs, and the plain versions on the
   card against the CPU's; then one grad-stage loss and its parameter
   gradients at the card's z tables, kernels on the card against the plain
   path on the CPU: with the chunked shade (``--no_fused_train``), with the
   fused training shade, and with it on the ``-f`` scene at its shapes (10
   frames x 8 rays: row 7 at 208 points a frame); the chunked shade in
   float32 (``--shade_f32``, as its limits were read) and in bf16 (the
   card's default) against the same bf16 shade on the CPU; beside the fused ones,
   how far the z tables themselves move card vs CPU, held to a limit
   derived from the float64-exponential reading (``Z_MOVED_F64``), with the
   sampler's exponentials in float32 as the control that must exceed it,
   and, report only, on the CPU with float64 products; then 256 hand and
   object rays of a frame,
   the card's z tables given to both sides, composited maps on the card
   against the CPU; then the sampler in proposal mode: row 1 and no row 5-6
   launched, the sdf the card's proposal read against the CPU's at the same
   inputs, the z samples moved under ``Z_MOVED_F64``'s rule with the
   card's proposal unrounded (float32) as the control beyond it.
5. The training slice: ``hold_tpu_torch.train.run_training`` on the
   synthetic sequence (12 frames, 240x320) at full width, 10 frames x 128
   rays = 1280 rays per step: 6 steps with the defaults (fused sampler,
   fused training shade), meshing and validation on, two steps an epoch
   (so that the nodes are meshed at epoch 3, after the last step, on the
   worker thread, and the object's state adopted when it ends; and that
   epoch 3, ``--eval_every_epoch`` 3, writes ``step_000000006.pt`` with
   ``last.pt`` on it and renders one validation frame: its panel and a
   finite ``val/psnr`` must be there; the steps' times stay clean of both);
   then that run's parameters meshed again at the reference's resolutions,
   timed (SDF queries on the device, MISE on the host), the object's state
   from it must turn the object's sparse and eikonal terms on, and 3 steps
   with it and 3 with the empty state give grad_ms side by side; then the
   fused run resumed: at its saved step its parameters and Adam state must
   equal the checkpoint's bit for bit, then 2 more steps, which write
   ``step_000000008.pt`` and validate; then 3 steps with
   ``--no_fused_sampler`` (the layer-by-layer sampler), 3 steps with
   ``--no_fused_train`` (the chunked shade, each chunk recomputed in the
   backward, its products in bf16), 2 more with ``--shade_f32`` and 2 with
   ``--no_remat`` (for their device time and peak memory);
   2 steps of ``-f`` through the CLI's parser (8 rays a frame, the sampler
   at 16 / 32 / 8 samples, 2 rounds); and a two-hand sequence: phase 4's
   fused agreement at 16 rays, then 3 steps at 1280 rays, each hand running
   its own rows 2, 3 and 5 and row 7 shading three nodes.  Every kernel's
   launch counter is set to 0 just before each run.  Every loss must be
   finite and every kernel of a path launched in its run, and none off it;
   one more step of each run under torch.profiler gives the device time of
   each stage by kernel family.  The fused run streams its metrics to a
   ``jsonl:`` remote sink.
6. The render slice: ``hold_tpu_torch.render_cli`` loads the fused run's
   checkpoint and renders two full frames at ``render_downsample`` 2
   (120x160 = 19,200 rays, 4096 a chunk), counters at 0 just before: the
   maps must be finite and exactly the render path's kernels launched.  Then
   phase 3's chunk again with the chunked render shade
   (``--no_fused_render``), in float32 and in bf16, whose PSNR against the
   fused render must reach ``PSNR_FLOOR``, one frame under torch.profiler
   for the device time by kernel family, and the same frames rendered by
   ``render_cli.render_on`` in two gloo ranks sharing the card (each
   chunk's pixels split over them): every map, panel and normal export bit
   for bit the one-process run's, each rank's walls and launches.
7. Evaluation: ``hold_tpu_torch.evaluate`` on the fused run's experiment
   against the synthetic ground truth (servers on the card, metrics and ICP
   on the host; no kernel launched): every metric finite, the ICP's too;
   then on a sequence made with ``pose_noise`` 0.3 after 2 steps from its
   noised poses, against its ``entities_gt``.  Walls split into the servers
   and the host's metrics.
8. Refinement and viewing: ``hold_tpu_torch.optimize_ckpt`` on the fused
   run's checkpoint at step 8 (its object mesh from the epoch-3 meshing) at
   the CLI's defaults (masks at ``--target_dim`` 300, batches of 10 frames,
   the object decimated to 5,000 faces) but ``--iters`` 4, GIFs on: the
   refined checkpoint at step 999,000,000 read back, finite, its frozen
   leaves and rejected batches the source's bit for bit and its kept ones
   the fit's; ``evaluate`` (at ``--icp_iters`` 40) and ``visualize_ckpt``
   (12 PNGs, ``overlay.mp4``, ``viewer.html``) on it, with no kernel of the
   port launched on either path; a fit iteration at the 10-frame batch
   timed, its launches and peak memory; one FittingProblem card against
   CPU on 2 frames with masks at 48 (one hand, two hands): loss terms, free
   leaves' gradients, 5 iterations of ``run_fit``; the generator's
   ``fit_mano_to_verts`` and ``AlignmentProblem.fit`` (h, o, ho) on the
   sequence's 12 frames, card against CPU, timed.
9. Real-format data: an HO3D v3 sequence in the raw layout (12 frames,
   one without annotations; a cube as the scanned object) through
   ``process_ho3d``'s CLI, then ``evaluate --gt ho3d`` on the fused run's
   step-8 checkpoint on the card (every metric finite, no kernel), the
   card's ``gt_ho3d`` against the CPU's within ``GT_BUS_ATOL``; then a
   sequence that ``build_dataset.build_from_arrays`` makes from the
   synthetic sequence's frames, masks, cameras and fits, trained 2 steps
   (the "built" path).
10. Data parallel: the slice's defaults for 2 steps from a seed checkpoint
   at step 9000 (the fused run's step 8, the hand's surface set to cut the
   rays), validating after each, in one process and in two ranks that share
   the card through gloo (``parallel.sharding.launch``): the per-term
   losses, the parameters after each step and the validation psnr held to
   one process's under ``DP_*`` limits; two controls in the same ranks must
   fail them (ranks that average their own masked means, ranks that skip
   the all-reduce); the ranks' parameters equal; each rank's launches.
   Then one step in an NCCL group of one process, and phase 5's fused run's
   metrics read back from its ``jsonl:`` remote sink.  The seed's step is
   past the proposal's warmup, which phase 10 moves past its runs, so that
   it drives the fused sampler as before.
11. The proposal net and the sampler's knobs at full width
   (``PROPOSAL_RUNS``): 4 steps at 1,280 rays and 3 at 5,120 (10 frames x
   512), proposal mode from step 2; 1 step at 5,120 in proposal mode from
   step 0 (the undistilled surrogate); 3 steps at 1,280 with
   ``--node_bounds --sampler_relu --sampler_knn_stride 4`` (the relu trunk
   and the strided search, then proposal mode on the strided set); 2 steps
   each at 10,240 and 20,480 rays (the JAX bench's larger shapes), proposal
   mode from step 1.  Each
   step: every loss term, parameter and z table finite, z sorted,
   ``loss/proposal`` > 0, row 1 in proposal mode and rows 5-6 otherwise;
   per mode the stages' walls, one profiled step's device time and
   launches, and the peak memory.

Phase 5 also times the sampler stage with its exponentials in float64 (as
it runs) and in float32 (as before their repair): wall, launches, device
time.

The last three lines of standard output are the card's name and power
limit, one JSON object describing the kernels (errors, kernel and plain
times, the bound from this run's shapes, launches per path, "refine" and
"visualize" among them; the relu forms under their own counters, the
stride-4 forms counted as their kernel's launches in the "knobs" run), and
``{"ok": true, "device": {...}}``.  Without a CUDA device, or run from a
directory that does not hold the hold_tpu_torch package, it exits non-zero
and prints no result.  ``--phases`` runs phases 1-2 and then only those
listed of 3, 4 and 11 (5-10 depend on each other): a partial run for
development, which prints no result.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
# phase 5's fused run streams its metrics here (a jsonl: remote sink); phase
# 10 reads them back
REMOTE_SPOOL = os.path.join(ROOT, "logs", "chip_smoke", "remote_spool.jsonl")
STEPS = 6
FRAMES, IMG_HW = 12, (240, 320)
BATCH_SIZE, RAYS_PER_FRAME = 5, 128
LAYER_STEPS = 3
RENDER_FRAMES, RENDER_DOWNSAMPLE, PIXEL_PER_BATCH = 2, 2, 4096
SOURCES = {"knn": "hold_tpu_torch/csrc/knn.cu", "pm": "hold_tpu_torch/csrc/point_mesh.cu",
           "fq": "hold_tpu_torch/csrc/fused_query.cu",
           "fr": "hold_tpu_torch/csrc/fused_render.cu", "fs": "hold_tpu_torch/csrc/fused_shade.cu"}
# kernel name -> (source, TPU kernel it replaces: file:line of the pallas_call,
# the runs whose path launches it: "fused" (phase 5, the defaults), "layer"
# (phase 5, --no_fused_sampler), "chunked" (phase 5, --no_fused_train),
# "render" (phase 6)).  The point-buffer forms of the fused query and the KNN
# blend kernels are on no path, in the JAX package as here: phase 3 alone
# drives them.
# Since the training loop validates and resumes, also "resume" (phase 5, the
# fused run resumed for 2 steps), "fast" (phase 5, -f) and "two_hands"
# (phase 5, a two-hand sequence); the fused and resumed runs validate, so
# they launch the render kernels too.
# Phase 9 trains a sequence that build_dataset made ("built"); phase 10 the
# defaults in one process ("dp_one", validating), in each of two ranks
# ("dp_rank0", "dp_rank1", validating) and in an NCCL group of one process
# ("dp_nccl").
# Phase 11 trains four runs at full width with the proposal's warmup cut
# (PROPOSAL_RUNS): "prop_1280" and "prop_5120" (the trunk sampler, then
# proposal mode), "prop_5120_step0" (proposal mode from step 0) and "knobs"
# (--node_bounds --sampler_relu --sampler_knn_stride 4: the fused query's
# relu trunk and strided search, then proposal mode on the strided set).
DP_PATHS = ("dp_one", "dp_rank0", "dp_rank1", "dp_nccl")
PROPOSAL_PATHS = ("prop_1280", "prop_5120", "prop_5120_step0", "knobs", "prop_10240",
                  "prop_20480")
GRAD = ("fused", "layer", "chunked", "resume", "fast", "two_hands", "built") + DP_PATHS \
    + PROPOSAL_PATHS
# phase 6 renders in one process ("render") and in two ranks sharing the card
# ("render_rank0", "render_rank1")
RENDER_PATHS = ("render", "render_rank0", "render_rank1")
FUSED_SAMPLER = ("fused", "chunked", "resume", "fast", "two_hands", "built") + RENDER_PATHS \
    + DP_PATHS \
    + ("prop_1280", "prop_5120", "prop_10240", "prop_20480")
FUSED_SHADE = ("fused", "layer", "resume", "fast", "two_hands", "built") + DP_PATHS \
    + PROPOSAL_PATHS
# the sampler's warp ahead of the proposal net or the layer-by-layer trunk
SAMPLER_WARP = ("layer",) + PROPOSAL_PATHS
# the runs that render: phase 6, and the training runs that validate
RENDER = RENDER_PATHS + ("fused", "resume", "dp_one", "dp_rank0", "dp_rank1")
KERNELS = {
    "knn_inverse_warp": ("knn", "hold_tpu/ops/knn.py:416", SAMPLER_WARP),
    "knn_inverse_warp_diff.fwd": ("knn", "hold_tpu/ops/knn.py:547", GRAD),
    "knn_inverse_warp_diff.bwd": ("knn", "hold_tpu/ops/knn.py:581", GRAD),
    "knn_jacobian_inverse.fwd": ("knn", "hold_tpu/ops/knn.py:737", GRAD),
    "knn_jacobian_inverse.bwd": ("knn", "hold_tpu/ops/knn.py:781", GRAD),
    "min_vertex_dist": ("pm", "hold_tpu/ops/point_mesh.py:228", GRAD),
    "fused_hand_sampler_sdf_z": ("fq", "hold_tpu/ops/fused_query.py:484", FUSED_SAMPLER),
    "fused_object_sampler_sdf_z": ("fq", "hold_tpu/ops/fused_query.py:520", FUSED_SAMPLER),
    "fused_shade_train.fwd": ("fs", "hold_tpu/ops/fused_shade.py:294", FUSED_SHADE),
    "fused_shade_train.bwd": ("fs", "hold_tpu/ops/fused_shade.py:315", FUSED_SHADE),
    "fused_hand_sampler_sdf": ("fq", "hold_tpu/ops/fused_query.py:389", ()),
    "fused_object_sampler_sdf": ("fq", "hold_tpu/ops/fused_query.py:419", ()),
    "fused_hand_render": ("fr", "hold_tpu/ops/fused_render.py:480", RENDER),
    "fused_object_render": ("fr", "hold_tpu/ops/fused_render.py:514", RENDER),
    "knn_blend_weights": ("knn", "hold_tpu/ops/knn.py:144", ()),
    "knn_blend_weights_t": ("knn", "hold_tpu/ops/knn.py:254", ()),
    # the relu trunk (query_trunk_kernel<true>): its own launch counters
    "fused_hand_sampler_sdf_z.relu": ("fq", "hold_tpu/ops/fused_query.py:484", ("knobs",)),
    "fused_object_sampler_sdf_z.relu": ("fq", "hold_tpu/ops/fused_query.py:520", ("knobs",)),
    "fused_hand_sampler_sdf.relu": ("fq", "hold_tpu/ops/fused_query.py:389", ()),
    "fused_object_sampler_sdf.relu": ("fq", "hold_tpu/ops/fused_query.py:419", ()),
}
# forms of a kernel that share its counter (the same instance on another
# vertex set): the form -> the counter whose launches in the "knobs" run are
# all of that form (its sampler searches every 4th MANO vertex)
STRIDE = 4
FORMS = {"knn_inverse_warp.stride4": ("knn_inverse_warp", "knobs"),
         "fused_hand_sampler_sdf_z.stride4": ("fused_hand_sampler_sdf_z.relu", "knobs")}
# the card's peak rates (NVIDIA's H100 SXM data sheet, dense, at 700 W):
# bf16 tensor cores, f32 outside them, device memory
PEAK_BF16, PEAK_F32, PEAK_BYTES = 989e12, 67e12, 3.35e12
# the fused query against its plain version: the JAX package's own bound
# between its fused and layer-by-layer sampler (tests/test_fused_query.py),
# |d| <= 2e-2 and mean |d| <= 4e-3, with |d| scaled by max(1, |sdf|).  Both
# versions round every activation to bf16 (8 bits), and their sums differ in
# order, so a rounding step falls on different sides now and then; the step
# grows with the value.  The object's canonical space is world space over its
# scale (0.1 here), so far samples reach |sdf| ~ 30.
FQ_MAX, FQ_MEAN = 2e-2, 4e-3
# the render kernels against their plain versions (phase 3): sdf as FQ_MAX /
# FQ_MEAN scaled by max(1, |sdf|), as for the query; x_c and the nearest
# distance are computed op for op alike (1e-5).  The JAX package holds its
# fused render to its XLA shade at rgb 3e-2 and normal p99 0.08
# (tests/test_fused_render.py); here both sides round at the same places, so
# the bounds are tighter: on an H100 the kernels read rgb 1.1e-4 (hand) and
# 1.9e-3 (object), normal p99 1.1e-3 and max 7.9e-3 (hand), 1.5e-2 (object),
# on the frame's first 4096 pixels.  A normal's error grows as |dSDF/dx|
# shrinks, hence the looser max.
RENDER_RGB, RENDER_NRM_P99, RENDER_NRM_MAX = 1e-2, 1e-2, 0.1
# the fused training shade's backward against its plain version (phase 3)
# and the fused grad stage, card against CPU (phase 4): the JAX package's
# bound between its kernel and the same math in XLA
# (tests/test_fused_shade.py), |d| <= rtol |ref| + atol max|ref|, applied in
# phase 3 to each part of a returned tensor on its own (x_c, J^-1, their
# rows next to where the backward's work divides, the frame bias, every
# matrix and bias row of the packs, the SDF head's bias) and in phase 4 to
# each parameter's gradient.  A part may have a share of its elements
# beyond the bound and none beyond a cap times it: GRAD_LIMITS by the kind
# of part, AGREE_LIMIT in phase 4.  Beside the kernel, each part is read for
# the plain version with its products summed in float64 (sound: the same
# math, another summation) and for a control that must fail: in phase 3 the
# plain version without its bf16 roundings, in phase 4 the chunked f32
# shade.  Set from those readings on an H100 (PERF.md), at 10 x
# 12,544 points under seeded cotangents, with only the tail rows' too: the
# per-point gradients read at most 0.87 of the bound (sound 0.60, control
# up to 3.5); the sums through the trunk at most 4.6 with 1.0 % of a part
# beyond (sound 3.0 and 0.4 %, control up to 34 and 44 %); the sums through
# the colour net's hidden layers and the frame bias, whose terms cancel so
# that a flipped bf16 rounding moves them far beyond their scale, at most
# 9.9 with 58 % beyond (sound 8.2 and 46 %, control up to 71); of those the
# frame bias at most 8.2 with 7.9 % beyond (sound 4.6 and 3.6 %, control
# 12 and 44 %; each frame's first 16 points counted in the frame before
# 8.0 and 20-28 %).  Under the cotangents of the JAX package's test loss,
# which do not cancel, the sums read at most 0.27 (sound 0.25, control up
# to 1.6) and are held to the bound itself, while a per-point gradient whose
# terms cancel within the point reads up to 2.0 on 0.007 % of its elements
# (sound 1.7 and 0.001 %, control 9.0 and 1.1 %): LOSS_LIMITS.
SHADE_GRAD_RTOL, SHADE_GRAD_ATOL = 5e-3, 5e-3
GRAD_LIMITS = {"point": (0.0, 1.0), "trunk": (2e-2, 8.0), "colour": (1.0, 15.0),
               "frame bias": (0.12, 15.0)}
LOSS_LIMITS = {"point": (5e-4, 4.0), "trunk": (0.0, 1.0), "colour": (0.0, 1.0),
               "frame bias": (0.0, 1.0)}
# Limits set at one N hold only there: a sum over 208 points a frame (-f's
# 8 rays x 26 samples) cancels otherwise than one over 12,544.  The rule at
# every N: for each kind of part and each set of cotangents, the cap is at
# least 1.1x the worst of the kernel's and the float64 reading's at that N,
# the share beyond the bound at least 1.1x theirs, and the unrounded
# control's worst of the kind exceeds the cap or its share.  At 12,544 the
# limits above do that (readings above) and stay.  At N = 208 (both
# nodes of a -f grad stage, on an H100; kernel | float64 | control, worst
# and share beyond): seeded cotangents, with the tail rows' alone too,
# per-point 0.541 | 0.541 | 2.50 (0.71 %), trunk 3.85 (1.2 %) | 3.86
# (0.39 %) | 26.6 (64 %), colour 7.87 (38 %) | 5.27 (24 %) | 22.9 (82 %),
# frame bias 13.2 (11 %) | 5.42 (4.9 %) | 43.1 (63 %); the JAX test's loss,
# per-point 0.734 | 0.649 | 3.04 (1.1 %), trunk 0.093 | 0.057 | 0.821,
# colour 0.523 | 0.542 | 1.32, frame bias 1.01 (0.039 %) | 1.09 (0.039 %) |
# 6.11 (0.78 %).  So at 208 the frame bias's share under seeded cotangents
# (11 % against 12 %) and its cap under the JAX test's loss (1.09 against
# 1.0) are set anew, and the trunk's cap under that loss is tightened to
# lie below its control's 0.821.
GRAD_LIMITS_208 = dict(GRAD_LIMITS, **{"frame bias": (0.2, 15.0)})
LOSS_LIMITS_208 = dict(LOSS_LIMITS, **{"trunk": (0.0, 0.5), "frame bias": (1e-3, 2.0)})
# At the JAX bench's step shapes (bench_shape_checks: 5,120 / 10,240 /
# 20,480 rays, N = 50,176 / 100,352 / 200,704, each node's recorded grad
# stage, the plain versions on the first 8 / 4 / 2 frames, 401,408 points
# each; on an H100; kernel | float64 | control, the worst of both nodes and
# the largest share beyond, seeded cotangents and the tail rows' alone
# together):
# - 50,176: per-point 1.170 (5.5e-07) | 0.921 (0) | 3.398 (0.061 %), trunk
#   7.407 (1.9 %) | 6.908 (0.78 %) | 77.0 (43 %), colour 6.156 (34 %) |
#   3.736 (17 %) | 27.2 (83 %), frame bias 8.497 (13 %) | 4.290 (5.8 %) |
#   16.5 (54 %); the JAX test's loss, per-point 3.392 (5.2e-05) | 2.203
#   (2.1e-05) | 5.866 (1.4 %), trunk 0.020 | 0.004 | 0.332, colour 0.016 |
#   0.021 | 0.625, frame bias 0.038 | 0.082 | 1.054 (0.049 %);
# - 100,352: per-point 1.295 (8.3e-07) | 1.295 (2.8e-07) | 6.246 (0.19 %),
#   trunk 5.352 (3.9 %) | 2.856 (1.2 %) | 45.4 (47 %), colour 7.253 (56 %) |
#   3.836 (27 %) | 30.7 (84 %), frame bias 5.118 (18 %) | 2.753 (3.8 %) |
#   17.8 (59 %); the loss, per-point 2.555 (6.2e-05) | 2.929 (2.7e-05) |
#   11.1 (1.5 %), trunk 0.043 | 0.015 | 0.577, colour 0.031 | 0.016 | 0.599,
#   frame bias 0.058 | 0.038 | 1.092 (0.098 %);
# - 200,704: per-point 1.524 (2.2e-05) | 0.806 (0) | 5.690 (0.15 %), trunk
#   5.047 (2.3 %) | 2.662 (0.78 %) | 45.1 (51 %), colour 5.781 (33 %) |
#   8.137 (19 %) | 40.6 (76 %), frame bias 2.681 (9.2 %) | 3.886 (5.3 %) |
#   16.1 (56 %); the loss, per-point 2.471 (6.6e-05) | 2.181 (1.3e-05) |
#   6.132 (1.2 %), trunk 0.090 | 0.009 | 0.727, colour 0.025 | 0.018 |
#   0.673, frame bias 0.036 | 0.010 | 1.154 (0.20 %).
# So the per-point cap and share, the trunk's share (and at 50,176 its cap)
# and the frame bias's share are set anew where the readings pass 12,544's;
# under the JAX test's loss the trunk's, colour's and frame bias's caps are
# tightened to lie below their controls' (0.23-0.73 at these N, against up
# to 1.6 at 12,544).  A sum over 50,176 points or more hides a few misplaced
# points under its rounding: the frame-boundary control (shade_case) read
# 0.84-3.5 there moving 16 points a frame, and with N // 784 (the share of a
# frame 16 are at 12,544) the hand at 200,704 read 2.311 (9.2 %), within the
# frame bias's limits.  So beyond 12,544 it moves N // 196 points a frame
# (256 / 512 / 1,024, two to eight of the backward's 128-point CTAs); these
# limits cannot see fewer.
LOSS_LIMITS_BENCH = dict(LOSS_LIMITS, **{"trunk": (0.0, 0.2), "colour": (0.0, 0.3),
                                         "frame bias": (0.0, 0.5)})
GRAD_LIMITS_50176 = dict(GRAD_LIMITS, **{"point": (1e-6, 1.3), "trunk": (0.025, 8.5),
                                         "frame bias": (0.15, 15.0)})
GRAD_LIMITS_100352 = dict(GRAD_LIMITS, **{"point": (1e-6, 1.5), "trunk": (0.045, 8.0),
                                          "frame bias": (0.2, 15.0)})
GRAD_LIMITS_200704 = dict(GRAD_LIMITS, **{"point": (3e-5, 1.7), "trunk": (0.03, 8.0)})
# points a frame -> (GRAD_LIMITS, LOSS_LIMITS) derived at that N
SHADE_LIMITS = {12544: (GRAD_LIMITS, LOSS_LIMITS), 208: (GRAD_LIMITS_208, LOSS_LIMITS_208),
                50176: (GRAD_LIMITS_50176, LOSS_LIMITS_BENCH),
                100352: (GRAD_LIMITS_100352, LOSS_LIMITS_BENCH),
                200704: (GRAD_LIMITS_200704, LOSS_LIMITS_BENCH)}
COLOUR_PARTS = ("bw.feat_w", "cw.C0a", "cw.C0f", "cw.C1", "cw.C2", "cw.C3", "cw.cbias0",
                "cw.cbias1", "cw.cbias2", "cw.cbias3")
# phase 4, 16 rays: the card at most 2.5 with 0.4 % of a tensor beyond,
# the CPU's own float64 reading 1.9 and 0.4 %, the chunked shade 2.5 and 25 %
AGREE_LIMIT = (1e-2, 5.0)
# phase 4, the bf16 chunked shade (--no_fused_train, the card's default)
# against the same shade on the CPU, 16 rays, by AGREE_LIMIT's method: on
# an H100 the card read every one of 134 gradients within the bound, worst
# 0.943; the CPU's f32 chunked shade (the control) 5.470, 28 tensors beyond
# and up to 37.5 % of a tensor.  So a share of 1e-3 and twice the card's
# worst, which the control exceeds
BF16_AGREE_LIMIT = (1e-3, 2.0)
# one render chunk, card against CPU (phase 4), on the composited maps: the
# per-sample rgb bound integrated over a ray stays under it; normals are
# averaged unit vectors; the mask and depth move with the density, which
# moves with the sdf's bf16 steps
RENDER_MAP_TOL = {"rgb": 3e-2, "mask_prob": 3e-2, "normal": 8e-2, "depth": 3e-2}
# phase 4: the z samples that move farther than 0.1 x their ray's median
# spacing, card against CPU, in the worst node of each agreement check.
# The sampler's exponentials are in float64 on both devices; what still
# moves comes from the sdf, which the card reads through the fused query
# (bf16, its sums in another order) and the CPU through the plain
# version.  On an H100 the worst node (the object) moved, in samples of its
# z table: one hand 24 of 3136 (0.765 %), -f 8 of 2080, two hands 37 of
# 3136; with the exponentials in float32 (the control) 46, 51 and 126.
# The limit of each check is that float64 count plus three times its square
# root (the count's Poisson spread), over the table's samples: 1.234 %,
# 0.793 % and 1.762 %; each control lies beyond its own.  In proposal mode
# (1 pair of frames x 16 rays) the worst node (the hand) moved 115 of 3136
# samples (3.667 %; the object 2.232 %), with float32 exponentials 116: the
# bf16 surrogate's roundings, not the exponentials, move these samples, so
# its control is the card's surrogate on its float32 tree, 212 (6.760 %),
# beyond the limit of 4.693 %.
Z_MOVED_F64 = {"one hand": 24, "fast": 8, "two hands": 37, "proposal": 115}


def z_moved_limit(case: str, samples: int) -> float:
    n = Z_MOVED_F64[case]
    return (n + 3.0 * math.sqrt(n)) / samples
# the rays of the render checks are the pixels the ground-truth mask marks
# as hand or object; their composited mask_prob must reach this, or the
# check would compare background
MASK_FLOOR = 0.5
# the fused render against the chunked f32 render shade (phase 6): a render
# whose every pixel were off by the JAX package's per-sample rgb bound
# between the two, 3e-2, would score 20 log10(1 / 3e-2) = 30.5 dB
PSNR_FLOOR = 30.0


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def cuda_ms(torch, fn, fill_ms: float = 100.0, max_reps: int = 5000) -> float:
    """Mean milliseconds of ``fn`` over enough back-to-back launches to fill
    ``fill_ms`` (at least 3), after one warm-up and one timed call."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def timed(reps):
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    fn()
    once = timed(1)
    return timed(min(max(3, math.ceil(fill_ms / max(once, 1e-3))), max_reps))


def kernel_split(torch, label: str, fn, keys: tuple, calls: int = 3,
                 tries: int = 3) -> dict | None:
    """Device ms a call of ``fn`` by kernel (``keys``: substrings of kernel
    names; the rest as "other"), from torch.profiler over ``calls`` calls;
    printed under ``label``, and None when the profiler saw no device events
    in ``tries`` profiles (on an H100 it once saw none for a call of two
    kernels of a few microseconds)."""
    from torch.profiler import ProfilerActivity, profile

    split = {}
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                key = next((k for k in keys if k in e.name), "other (memset, copies, elementwise)")
                split[key] = split.get(key, 0.0) + e.time_range.elapsed_us() / (1e3 * calls)
        if split:
            break
    if not split:
        print(f"  {label} by kernel: not measured (the profiler saw no device events)", flush=True)
        return None
    print(f"  {label} by kernel (torch.profiler, ms a call over {calls} calls): "
          + ", ".join(f"{k} {v:.4f}" for k, v in sorted(split.items())), flush=True)
    return split


def bound(tc_flops: float, f32_flops: float, nbytes: float) -> dict:
    """The least time the card could take: the largest of the tensor-core
    operations at the bf16 peak, the other operations at the f32 peak (the
    two pipes run at once) and the bytes moved (each input read once, each
    output written once) at the memory rate.  Operations count what the
    function needs, not a kernel's zero pads."""
    ops_ms = max(tc_flops / PEAK_BF16, f32_flops / PEAK_F32) * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "tc_flops": tc_flops, "f32_flops": f32_flops, "bytes": nbytes}


def knn_cost(n_pts: int, V: int, J: int, K: int = 15) -> float:
    """f32 operations of n_pts points' KNN blends by brute force: one sweep
    over V vertices (a distance of 8 operations and one comparison each),
    the exponential and J multiply-adds of the K vertices blended, the
    normalisation.  A second sweep is no work the function needs.  Only the
    brute-force bound reads it (``brute_force_bound_ms``, beside the bound)."""
    return n_pts * (9.0 * V + K * (2 * J + 2) + J)


def knn_needed(n_pts: int, V: int, J: int, K: int = 15) -> float:
    """f32 operations of n_pts points' KNN blends that no exact search
    avoids, from the inputs alone: the distances of the min(K, V) vertices
    that a point's set holds at least (9 operations each; a blend needs
    them), the exponential and J multiply-adds of each, the normalisation.
    The other vertices' distances are the search's work, and how many of
    them it needs depends on how it culls: they are not counted."""
    return n_pts * (9.0 * min(K, V) + K * (2 * J + 2) + J)


def search_counts(torch, label: str, fn) -> dict:
    """One call of ``fn`` with the vertex search's counters open
    (ops/knn.py count_search), printed under ``label``: knn.SEARCH_COUNTS
    and the share of warp-tiles culled."""
    from hold_tpu_torch.ops import knn

    with knn.count_search(torch.device("cuda")) as c:
        fn()
        torch.cuda.synchronize()
    out = dict(zip(knn.SEARCH_COUNTS, (int(x) for x in c.tolist())))
    vis, cul = out["tiles_visited"], out["tiles_culled"]
    out["culled_share"] = cul / max(vis + cul, 1)
    lanes = max(out["lanes"], 1)
    inserts = (f", {out['inserts'] / lanes:.1f} inserts a lane in "
               f"{32 * out['insert_rounds'] / lanes:.1f} rounds a warp" if out["inserts"] else "")
    print(f"  {label} search: {out['culled_share']:.4f} of {vis + cul} warp-tiles culled, "
          f"{out['tie_lanes']} of {out['lanes']} lanes took the tie sweep{inserts}", flush=True)
    return out


def check_support(torch, label: str, fn, pts, verts, skin) -> dict:
    """The blended weights ``fn()`` returns (a kernel's, (B, P, J)) against
    the plain version's at (pts, verts, skin): the same support exactly (the
    joints each point's neighbour set reaches: a set that gained or lost a
    vertex moves it), the weights within 1e-5 (the blend's sums run in
    another order); with the search's counts.  Raises on a difference."""
    from hold_tpu_torch.ops import knn

    with knn.count_search(torch.device("cuda")) as c:
        wb = fn()
        torch.cuda.synchronize()
    ref_w, _ = knn._blend_plain(pts, verts, skin, 15)
    lanes, tie, vis, cul = (int(x) for x in c.tolist()[:4])
    differ = int(((wb > 0) != (ref_w > 0)).sum())
    err = max_err(wb, ref_w)
    ok = differ == 0 and err <= 1e-5
    print(f"  {label}: neighbour support {differ} of {wb.numel()} weights differ, weights "
          f"max_abs_err {err:.3e} (tol 1e-5); {tie} of {lanes} lanes took the tie sweep, "
          f"{cul / max(vis + cul, 1):.4f} of {vis + cul} warp-tiles culled "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{label}: the neighbour sets differ from the plain version's")
    return {"support_differs": differ, "weights_max_abs_err": err, "lanes": lanes,
            "tie_lanes": tie, "culled_share": cul / max(vis + cul, 1)}


def object_mesh(params, scene):
    """The object's canonical mesh at the reference's resolutions (32,
    res_up 2) and its mesh state; raises unless the field has a surface and
    the state is valid."""
    from hold_tpu_torch.meshing.cano import mesh_object_cano
    from hold_tpu_torch.models.holdnet import object_mesh_state_from_mesh

    mesh = mesh_object_cano(params["object"], scene)
    if mesh is None or mesh.faces.shape[0] == 0:
        raise AssertionError("the object's field gave no mesh")
    state = object_mesh_state_from_mesh(mesh.vertices, mesh.faces, scene.device)
    if float(state["valid"]) != 1.0:
        raise AssertionError(f"the object's mesh ({mesh.vertices.shape[0]} vertices) gave an "
                             f"invalid mesh state")
    return mesh, state


def fixed_order_check(torch, label: str, kern, mirror) -> dict:
    """Rows 2-3's backward: two calls of ``kern`` must give the same tensors
    bit for bit, and equal ``mirror`` (ops/knn.py's plain PyTorch repetition
    of the kernels' summation order) bit for bit.  Times it by device time
    (torch.profiler, its two kernels) and by wrapper time (CUDA events
    around the call: the workspace's allocation and the launch too).
    Returns {"ms": device time, or the wrapper's when the profiler saw no
    device events, "extra": the readings}."""
    first, again, ref = kern(), kern(), mirror()
    torch.cuda.synchronize()
    same = all(bool(torch.equal(a, b)) for a, b in zip(first, again))
    equal = all(bool(torch.equal(a, c)) for a, c in zip(first, ref))
    print(f"  {label}: two calls bit for bit equal {same}, equal to the fixed-order plain "
          f"version bit for bit {equal} {'ok' if same and equal else 'FAIL'}", flush=True)
    if not (same and equal):
        raise AssertionError(f"{label}: the sums are not the fixed order's")
    wrapper_ms = cuda_ms(torch, kern)
    split = kernel_split(torch, label, kern, ("knn_tfs_bwd_kernel", "knn_tfs_bwd_final_kernel"))
    device_ms = sum(split.values()) if split else None
    device = "not measured" if device_ms is None else f"{device_ms:.4f} ms"
    print(f"  {label}: device {device}, wrapper {wrapper_ms:.4f} ms", flush=True)
    return {"ms": wrapper_ms if device_ms is None else device_ms,
            "extra": {"wrapper_ms": wrapper_ms, "split_ms": split, "bit_identical": same,
                      "equals_fixed_order": equal}}


def frame_bytes(B: int, V: int, J: int) -> float:
    """Per-frame inputs of a hand kernel: vertices, skinning weights, bones."""
    return B * (V * 12.0 + V * J * 4.0 + J * 64.0)


def kernel_label(ptxas_line: str) -> str:
    """'fused_render_kernel<true>' from ptxas's line naming a mangled entry
    function."""
    import re

    m = re.search(r"([a-z_]+_kernel)(I(?:Lb[01]E)+E)?", ptxas_line)
    if not m:
        return ptxas_line.strip()
    args = re.findall(r"Lb([01])E", m.group(2) or "")
    return m.group(1) + (f"<{', '.join('true' if a == '1' else 'false' for a in args)}>"
                         if args else "")


def max_err(a, b) -> float:
    return float((a.detach().float() - b.detach().float()).abs().max())


@contextlib.contextmanager
def products_in_f64(torch):
    """Every product ``a @ b`` of a float32 ``a`` summed in float64, then
    rounded to float32."""
    matmul = torch.Tensor.__matmul__
    torch.Tensor.__matmul__ = lambda a, b: (matmul(a.double(), b.double()).float()
                                            if a.dtype == torch.float32 else matmul(a, b))
    try:
        yield
    finally:
        torch.Tensor.__matmul__ = matmul


def check_bf16_query(name: str, got, ref, scaled_mean: bool = False) -> float:
    """|d| <= FQ_MAX * max(1, |ref|) and mean|d| <= FQ_MEAN (with
    ``scaled_mean`` the mean of |d| / max(1, |ref|)), else raise; returns
    max|d|."""
    d = (got.float() - ref.float()).abs()
    mag = ref.float().abs()
    err = float(d.max())
    mean = float((d / mag.clamp(min=1.0) if scaled_mean else d).mean())
    near = float(d[mag <= 1.0].max()) if bool((mag <= 1.0).any()) else 0.0
    worst = float((d / (FQ_MAX * mag.clamp(min=1.0))).max())
    ok = worst <= 1.0 and mean <= FQ_MEAN
    print(f"  {name}: max_abs_err {err:.3e} (at |sdf| <= 1: {near:.3e}; worst "
          f"|d| / ({FQ_MAX:g} max(1, |sdf|)) {worst:.3f}), mean_abs_err"
          f"{' / max(1, |sdf|)' if scaled_mean else ''} {mean:.3e} (tol {FQ_MEAN:g}), max "
          f"|sdf| {float(mag.max()):.2f} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return err


def bf16_query_reading(got, ref) -> tuple:
    """(worst |d| / (FQ_MAX max(1, |ref|)), mean |d|, within both bounds)."""
    d = (got.float() - ref.float()).abs()
    worst = float((d / (FQ_MAX * ref.float().abs().clamp(min=1.0))).max())
    mean = float(d.mean())
    return worst, mean, worst <= 1.0 and mean <= FQ_MEAN


def check_close(name: str, got, ref, rtol: float, atol: float) -> float:
    """max|got - ref| <= atol + rtol * max|ref|, else raise."""
    err = max_err(got, ref)
    tol = atol + rtol * float(ref.detach().abs().max())
    status = "ok" if err <= tol else "FAIL"
    print(f"  {name}: max_abs_err {err:.3e} (tol {tol:.3e} = {atol:g} + {rtol:g}*max|ref|) {status}",
          flush=True)
    if err > tol:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return err


def slice_config():
    from hold_tpu_torch.utils.config import Cfg, load_config

    cfg = load_config()  # the proposal net on, its warmup 1000 steps
    args = Cfg({
        "case": "synthetic", "lr": 1e-4, "num_sample": RAYS_PER_FRAME, "tempo_len": 2000,
        "offset": 1, "log_every": 1, "no_meshing": True, "no_vis": True, "mute": True,
        "exp_key": "chip_smoke", "barf_s": 1000, "barf_e": 10000, "seed": 0,
        "log_root": os.path.join(ROOT, "logs", "chip_smoke"), "total_step": STEPS,
    })
    return args, cfg


def kernel_checks(torch, seq, args, cfg, dev) -> dict:
    """Phase 3: every kernel against its plain version at slice shapes."""
    import numpy as np

    from hold_tpu_torch.models.holdnet import (
        _rays, build_scene, empty_object_mesh_state, init_scene_params, sample_all_z,
    )
    from hold_tpu_torch.models.mlp import resolve_weight_norm
    from hold_tpu_torch.models.nodes import _mano_pose, _object_pose
    from hold_tpu_torch.models.object_model import object_deform
    from hold_tpu_torch.ops import fused_query as fq
    from hold_tpu_torch.ops import knn, point_mesh
    from hold_tpu_torch.utils.transforms import inverse_mat3
    from hold_tpu_torch.render.ray_sampler import uniform_z_vals
    from hold_tpu_torch.render.volsdf import get_sphere_intersections
    from hold_tpu_torch.train import batch_to_device

    opt_model = dict(cfg["model"])
    scene = build_scene(opt_model, dict(args), seq.scene_data(), dev)
    params = init_scene_params(torch.Generator().manual_seed(0), scene, seq.scene_data())
    batch = batch_to_device(
        seq.sample_tempo_batch(np.random.RandomState(0), BATCH_SIZE, 1, RAYS_PER_FRAME), dev)
    B, P = batch["uv"].shape[:2]
    server = scene.servers["right"]
    with torch.no_grad():
        srv_out, _ = _mano_pose(params["right"], server, batch, 0)
    tfs = srv_out.tfs.detach().contiguous()
    verts = srv_out.verts.detach().contiguous()
    verts_c = server.verts_c.expand(B, -1, -1).contiguous()
    skin = server.skin_weights_c.expand(B, -1, -1).contiguous()
    ray_dirs, cam_loc = _rays(batch)
    far = get_sphere_intersections(cam_loc, ray_dirs, scene.sampler_cfg.scene_bounding_sphere)[:, 1:]
    z0 = uniform_z_vals(None, ray_dirs, cam_loc, torch.zeros_like(far), far,
                        scene.sampler_cfg.N_samples_eval)
    pts_s = (cam_loc[:, None] + z0[..., None] * ray_dirs[:, None]).reshape(B, -1, 3).contiguous()
    zs = sample_all_z(params, scene, batch, torch.Generator(dev).manual_seed(0), 0, 0)
    z = zs["right"]
    pts_g = (cam_loc[:, None] + z[..., None] * ray_dirs[:, None]).reshape(B, -1, 3).contiguous()
    rng = torch.Generator(dev).manual_seed(1)
    results = {}

    def record(name, err, ms, plain_ms, shape, cost, **extra):
        results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "shape": shape,
                         "library_ms": None, **cost, **extra}
        shown = {k: v for k, v in extra.items() if k not in ("buffers", "support", "search")}
        print(f"  {name} {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{cost['bound_ms']:.4f} ms ({cost['bound_by']}) {shown or ''}", flush=True)

    V, J = verts.shape[1], skin.shape[2]
    n_s, n_g = pts_s.shape[0] * pts_s.shape[1], pts_g.shape[0] * pts_g.shape[1]
    fbytes = frame_bytes(B, V, J)
    order = scene.plans["right"].tile_order  # the vertices' tile order, as the slice passes it
    no_library = ("no PyTorch call selects the K-th smallest distinct distance "
                  "with its ties")

    # 1: sampler warp, one error-bound round of 128 samples on 1280 rays
    got_x, got_o = knn.knn_inverse_warp(pts_s, verts, skin, tfs, order=order)
    ref_x, ref_o = knn.inverse_warp_plain(pts_s, verts, skin, tfs)
    err = check_close("knn_inverse_warp x_c", got_x, ref_x, 1e-5, 1e-5)
    if not torch.equal(got_o, ref_o):
        raise AssertionError("knn_inverse_warp: outlier mask differs")
    cnt = search_counts(torch, "knn_inverse_warp",
                        lambda: knn.knn_inverse_warp(pts_s, verts, skin, tfs, order=order))
    record("knn_inverse_warp", err,
           cuda_ms(torch, lambda: knn.knn_inverse_warp(pts_s, verts, skin, tfs, order=order)),
           cuda_ms(torch, lambda: knn.inverse_warp_plain(pts_s, verts, skin, tfs)),
           f"B={B} P={pts_s.shape[1]} V={verts.shape[1]}",
           bound(0, knn_needed(n_s, V, J) + n_s * (24 * J + 45), n_s * 25 + fbytes),
           search=cnt, library_note=no_library,
           brute_force_bound_ms=bound(0, knn_cost(n_s, V, J) + n_s * (24 * J + 45),
                                      n_s * 25 + fbytes)["bound_ms"])

    # 2: grad-stage warp, 98 samples on 1280 rays, forward and backward
    pts_r = pts_g.clone().requires_grad_(True)
    tfs_r = tfs.clone().requires_grad_(True)
    g = torch.randn(pts_g.shape, generator=rng, device=dev)
    got_x, got_o = knn.knn_inverse_warp_diff(pts_r, verts, skin, tfs_r, order=order)
    got_dp, got_dt = torch.autograd.grad(got_x, (pts_r, tfs_r), g)
    ref_x, ref_o = knn.inverse_warp_plain(pts_r, verts, skin, tfs_r)
    ref_dp, ref_dt = torch.autograd.grad(ref_x, (pts_r, tfs_r), g, retain_graph=True)
    err_f = check_close("knn_inverse_warp_diff x_c", got_x, ref_x, 1e-5, 1e-5)
    if not torch.equal(got_o, ref_o):
        raise AssertionError("knn_inverse_warp_diff: outlier mask differs")
    err_p = check_close("knn_inverse_warp_diff d/dpts", got_dp, ref_dp, 1e-5, 1e-5)
    # the per-frame transform gradient sums 12,544 points in another order
    # than the plain version's autograd: fp32 reduction-order tolerance
    err_t = check_close("knn_inverse_warp_diff d/dtfs", got_dt, ref_dt, 2e-5, 1e-5)
    shape = f"B={B} P={pts_g.shape[1]} V={verts.shape[1]}"

    def warp_fwd(p, v):
        return knn._warp_fwd_cuda(p, v, skin, tfs, 15, 0.1, True, "knn_inverse_warp_diff.fwd",
                                  order)

    # the neighbour sets, exactly: the blended weights' support against the
    # plain version's, as given and with a block of the hand's vertices
    # duplicated (ties at and under the K-th value)
    verts_tie = verts.clone()
    verts_tie[:, 300:364] = verts[:, 100:164]
    support = {}
    for tag, vv in (("as given", verts), ("vertices 100-163 duplicated", verts_tie)):
        support[tag] = check_support(torch, f"knn_inverse_warp_diff, {tag}",
                                     lambda: warp_fwd(pts_g, vv)[3], pts_g, vv, skin)
    x_t, o_t, _, _ = warp_fwd(pts_g, verts_tie)
    ref_xt, ref_ot = knn.inverse_warp_plain(pts_g, verts_tie, skin, tfs)
    check_close("knn_inverse_warp_diff x_c, vertices 100-163 duplicated", x_t, ref_xt, 1e-5,
                1e-5)
    if not torch.equal(o_t, ref_ot):
        raise AssertionError("knn_inverse_warp_diff: outlier mask differs (duplicated vertices)")
    if support["vertices 100-163 duplicated"]["tie_lanes"] == 0:
        raise AssertionError("the duplicated vertices sent no lane through the tie sweep")
    cnt = search_counts(torch, "knn_inverse_warp_diff.fwd", lambda: warp_fwd(pts_g, verts))
    record("knn_inverse_warp_diff.fwd", err_f, cuda_ms(torch, lambda: warp_fwd(pts_g, verts)),
           cuda_ms(torch, lambda: knn.inverse_warp_plain(pts_g, verts, skin, tfs)), shape,
           bound(0, knn_needed(n_g, V, J) + n_g * (24 * J + 45),
                 n_g * (25 + 36 + 4 * J) + fbytes),
           search=cnt, support=support, library_note=no_library,
           brute_force_bound_ms=bound(0, knn_cost(n_g, V, J) + n_g * (24 * J + 45),
                                      n_g * (25 + 36 + 4 * J) + fbytes)["bound_ms"])
    _, _, inv, wb = warp_fwd(pts_g, verts)
    xc_g = got_x.detach()
    bwd = fixed_order_check(torch, "knn_inverse_warp_diff.bwd",
                            lambda: knn._warp_bwd_cuda(g, inv, xc_g, wb),
                            lambda: knn.warp_bwd_fixed_order(g, inv, xc_g, wb))
    record("knn_inverse_warp_diff.bwd", max(err_p, err_t), bwd["ms"],
           cuda_ms(torch, lambda: torch.autograd.grad(ref_x, (pts_r, tfs_r), g,
                                                      retain_graph=True)), shape,
           bound(0, n_g * (30 + 24 * J), n_g * (72 + 4 * J) + B * J * 64),
           library_note="no PyTorch call computes this closed-form VJP", **bwd["extra"])

    # 3: inverse skinning Jacobian at the canonical points
    xc = got_x.detach().contiguous()
    tfs_r = tfs.clone().requires_grad_(True)
    gj = torch.randn(xc.shape[:2] + (9,), generator=rng, device=dev)
    got_j = knn.knn_jacobian_inverse(xc, verts_c, skin, tfs_r, order=order)
    (got_jt,) = torch.autograd.grad(got_j, tfs_r, gj)
    ref_j = knn.jacobian_inverse_plain(xc, verts_c, skin, tfs_r)
    (ref_jt,) = torch.autograd.grad(ref_j, tfs_r, gj, retain_graph=True)
    err_f = check_close("knn_jacobian_inverse J^-1", got_j, ref_j, 1e-5, 1e-5)
    err_t = check_close("knn_jacobian_inverse d/dtfs", got_jt, ref_jt, 2e-5, 1e-5)
    cnt = search_counts(torch, "knn_jacobian_inverse.fwd",
                        lambda: knn._jinv_fwd_cuda(xc, verts_c, skin, tfs, 15, order))
    record("knn_jacobian_inverse.fwd", err_f,
           cuda_ms(torch, lambda: knn._jinv_fwd_cuda(xc, verts_c, skin, tfs, 15, order)),
           cuda_ms(torch, lambda: knn.jacobian_inverse_plain(xc, verts_c, skin, tfs)), shape,
           bound(0, knn_needed(n_g, V, J) + n_g * (18 * J + 30), n_g * (48 + 4 * J) + fbytes),
           search=cnt, library_note=no_library,
           brute_force_bound_ms=bound(0, knn_cost(n_g, V, J) + n_g * (18 * J + 30),
                                      n_g * (48 + 4 * J) + fbytes)["bound_ms"])
    inv_j, wb_j = knn._jinv_fwd_cuda(xc, verts_c, skin, tfs, 15, order)
    bwd = fixed_order_check(torch, "knn_jacobian_inverse.bwd",
                            lambda: (knn._jinv_bwd_cuda(gj, inv_j, wb_j),),
                            lambda: (knn.jinv_bwd_fixed_order(gj, inv_j, wb_j),))
    record("knn_jacobian_inverse.bwd", err_t, bwd["ms"],
           cuda_ms(torch, lambda: torch.autograd.grad(ref_j, tfs_r, gj, retain_graph=True)),
           shape, bound(0, n_g * (108 + 18 * J), n_g * (72 + 4 * J) + B * J * 64),
           library_note="no PyTorch call computes this closed-form VJP", **bwd["extra"])

    # 4: min vertex distance on the four buffers the slice gives it: the
    # hand's subdivided mesh (in its tile order), the object's far-padded
    # buffer with the hand's vertices x 2 in its first rows, and the
    # all-padding empty object state, against the hand's canonical points;
    # and the object's mesh state as meshing makes it (these parameters'
    # field at the reference's resolutions) against the object's canonical
    # grad-stage points; the kernel must equal the plain version bit for
    # bit, within the limits below at worst
    cano = xc.reshape(-1, 3)
    M_sub = scene.sub_ops["right"][0]
    v_div = (M_sub @ srv_out.v_posed[0]).detach().contiguous()
    bound_v = empty_object_mesh_state(dev)["bound_centers"].clone()
    n_obj = server.verts_c.shape[1]
    bound_v[:n_obj] = server.verts_c[0] * 2.0
    mesh, state = object_mesh(params, scene)
    with torch.no_grad():
        obj_tfs = _object_pose(params["object"], scene.servers["object"], batch).obj_tfs
        pts_o = (cam_loc[:, None] + zs["object"][..., None] * ray_dirs[:, None]).reshape(B, -1, 3)
        cano_o = object_deform(pts_o, obj_tfs, inverse=True).reshape(-1, 3).contiguous()
    buffers = {"hand": (v_div, scene.plans["right"].sub_tile_order, cano),
               "object": (bound_v, None, cano),
               "empty object": (empty_object_mesh_state(dev)["bound_centers"], None, cano),
               "object mesh": (state["bound_centers"], None, cano_o)}
    print(f"  the object's mesh at these parameters: {mesh.vertices.shape[0]} vertices, "
          f"{mesh.faces.shape[0]} faces; its state keeps "
          f"{int((state['bound_centers'][:, 0] < 1e4).sum())} of {state['bound_centers'].shape[0]}"
          f" bound rows", flush=True)
    errs, by_buffer = [], {}
    for label, (vv, oo, pp) in buffers.items():
        got = point_mesh.min_vertex_dist_fast(pp, vv, oo)
        ref = point_mesh.min_vertex_dist(pp, vv)
        errs.append(check_close(f"min_vertex_dist {label} (P={pp.shape[0]} V={vv.shape[0]})",
                                got, ref, 1e-5, 1e-4))
        exact = bool(torch.equal(got, ref))
        print(f"    bit for bit equal to the plain version: {exact}", flush=True)
        cnt = search_counts(torch, f"min_vertex_dist {label}",
                            lambda: point_mesh.min_vertex_dist_fast(pp, vv, oo))
        n_c = pp.shape[0]
        nbytes = (n_c + vv.shape[0]) * 12.0 + n_c * 4
        by_buffer[label] = {
            "P": n_c, "V": vv.shape[0], "bit_equal": exact, "search": cnt,
            "ms": cuda_ms(torch, lambda: point_mesh.min_vertex_dist_fast(pp, vv, oo)),
            "library_ms": cuda_ms(torch, lambda: torch.cdist(pp, vv).amin(-1)),
            # one distance a point is the least an exact search evaluates
            **bound(0, n_c * 9.0, nbytes),
            "brute_force_bound_ms": bound(0, n_c * vv.shape[0] * 8.0, nbytes)["bound_ms"]}
        print(f"    kernel {by_buffer[label]['ms']:.4f} ms, torch.cdist + amin "
              f"{by_buffer[label]['library_ms']:.4f} ms, bound "
              f"{by_buffer[label]['bound_ms']:.4f} ms ({by_buffer[label]['bound_by']}; brute "
              f"force {by_buffer[label]['brute_force_bound_ms']:.4f})", flush=True)
    obj = by_buffer["object"]
    record("min_vertex_dist", max(errs), obj["ms"],
           cuda_ms(torch, lambda: point_mesh.min_vertex_dist(cano, bound_v)),
           f"P={cano.shape[0]} V={bound_v.shape[0]} (the object's buffer; also the hand, the "
           f"empty state and the object's mesh state)",
           {k: obj[k] for k in ("bound_ms", "bound_by", "tc_flops", "f32_flops", "bytes")},
           search=obj["search"], buffers=by_buffer, library_ms=obj["library_ms"],
           library_call="torch.cdist(pts, verts).amin(-1): two calls",
           brute_force_bound_ms=obj["brute_force_bound_ms"])

    # 5, 6, 12, 13: the fused sampler query, on the first round's 128
    # samples of 1280 rays (z forms) and the same points as a buffer; the
    # object's BARF window half open (all six bands partly weighted)
    S = z0.shape[1]
    z_t = z0.reshape(B, P, S).contiguous()
    packs, windows = {}, {}
    for nid in ("right", "object"):
        plans = scene.plans[nid]
        with torch.no_grad():
            packs[nid] = fq.pack_trunk_weights(resolve_weight_norm(params[nid]["implicit"]),
                                               plans.implicit)
        windows[nid] = fq.embed_window(plans.implicit, sum(plans.barf_cfg) // 2,
                                       plans.barf_cfg, dev)
    obj_tfs = _object_pose(params["object"], scene.servers["object"], batch).obj_tfs.detach()
    tf12 = torch.cat([inverse_mat3(obj_tfs[:, :3, :3]).reshape(B, 9), obj_tfs[:, :3, 3]],
                     dim=-1).contiguous()
    hand = (verts, skin, tfs, windows["right"], packs["right"])
    hand_kw = {"order": order}
    obj = (tf12, windows["object"], packs["object"])
    rays = (ray_dirs.contiguous(), cam_loc.contiguous(), z_t)
    pts_b = fq.points_from_rays_z(*rays)
    wbytes = fq.W_TOTAL * 2.0 + fq.F_TOTAL * 4.0
    act = 8 * 256 * 8.0  # softplus100 a hidden unit: f32 operations
    hand_f32 = knn_needed(1, V, J) + 24 * J + 45  # a point of the hand's warp
    # each kernel and plain call takes relu= (the relu trunk's form below)
    cases = (
        ("fused_hand_sampler_sdf_z",
         lambda relu=False: fq.fused_hand_sampler_sdf_z(*rays, *hand, relu=relu, **hand_kw),
         lambda relu=False: fq.hand_query_plain(pts_b, *hand, relu=relu).reshape(z_t.shape),
         f"B={B} P={P} S={S}", act + hand_f32, 8.0, wbytes + fbytes + B * P * 24),
        ("fused_object_sampler_sdf_z",
         lambda relu=False: fq.fused_object_sampler_sdf_z(*rays, *obj, relu=relu),
         lambda relu=False: fq.object_query_plain(pts_b, *obj, relu=relu).reshape(z_t.shape),
         f"B={B} P={P} S={S}", act + 24, 8.0, wbytes + B * P * 24),
        ("fused_hand_sampler_sdf",
         lambda relu=False: fq.fused_hand_sampler_sdf(pts_s, *hand, relu=relu, **hand_kw),
         lambda relu=False: fq.hand_query_plain(pts_s, *hand, relu=relu),
         f"B={B} N={pts_s.shape[1]}", act + hand_f32, 16.0, wbytes + fbytes),
        ("fused_object_sampler_sdf",
         lambda relu=False: fq.fused_object_sampler_sdf(pts_s, *obj, relu=relu),
         lambda relu=False: fq.object_query_plain(pts_s, *obj, relu=relu),
         f"B={B} N={pts_s.shape[1]}", act + 24, 16.0, wbytes),
    )
    for name, kern, plain, shape, f32_pp, bytes_pp, bytes_once in cases:
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        if got.shape != ref.shape or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{name}: shape {tuple(got.shape)} or non-finite values")
        err = check_bf16_query(name, got, ref)
        ms = cuda_ms(torch, kern)
        n = got.numel()
        record(name, err, ms, cuda_ms(torch, plain), shape,
               bound(2.0 * fq.TRUNK_MACS * n, f32_pp * n, bytes_pp * n + bytes_once),
               mean_abs_err=float((got - ref).abs().mean()),
               trunk_tflop_s=fq.TRUNK_FLOPS_PER_POINT * n / (ms * 1e-3) / 1e12)

    # the same four at shapes that are no multiple of the kernel's 128-point
    # tile (37 rays x 100 samples a frame; a buffer 61 points short), and the
    # hand's z form on one frame alone
    Pr, Sr = 37, 100
    rays_r = tuple(t.reshape(B, P, 3)[:, :Pr].reshape(-1, 3).contiguous() for t in rays[:2]) + (
        z_t[:, :Pr, :Sr].contiguous(),)
    pts_r = pts_s[:, :pts_s.shape[1] - 61].contiguous()
    rays_1 = (rays[0][:P].contiguous(), rays[1][:P].contiguous(), z_t[:1].contiguous())
    hand_1 = (verts[:1].contiguous(), skin[:1].contiguous(), tfs[:1].contiguous(), *hand[3:])
    for name, kern, plain, shape in (
        ("fused_hand_sampler_sdf_z", lambda: fq.fused_hand_sampler_sdf_z(*rays_r, *hand, **hand_kw),
         lambda: fq.hand_query_plain(fq.points_from_rays_z(*rays_r), *hand), f"B={B} P={Pr} S={Sr}"),
        ("fused_object_sampler_sdf_z", lambda: fq.fused_object_sampler_sdf_z(*rays_r, *obj),
         lambda: fq.object_query_plain(fq.points_from_rays_z(*rays_r), *obj),
         f"B={B} P={Pr} S={Sr}"),
        ("fused_hand_sampler_sdf", lambda: fq.fused_hand_sampler_sdf(pts_r, *hand, **hand_kw),
         lambda: fq.hand_query_plain(pts_r, *hand), f"B={B} N={pts_r.shape[1]}"),
        ("fused_object_sampler_sdf", lambda: fq.fused_object_sampler_sdf(pts_r, *obj),
         lambda: fq.object_query_plain(pts_r, *obj), f"B={B} N={pts_r.shape[1]}"),
        ("fused_hand_sampler_sdf_z", lambda: fq.fused_hand_sampler_sdf_z(*rays_1, *hand_1, **hand_kw),
         lambda: fq.hand_query_plain(fq.points_from_rays_z(*rays_1), *hand_1),
         f"B=1 P={P} S={S}"),
    ):
        got, ref = kern().reshape(-1), plain().reshape(-1)
        torch.cuda.synchronize()
        if got.shape != ref.shape or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{name} {shape}: shape {tuple(got.shape)} or non-finite values")
        results[name].setdefault("ragged", {})[shape] = check_bf16_query(f"{name} {shape}", got,
                                                                         ref)

    # 5, 6, 12, 13 with the relu trunk (query_trunk_kernel<true>) at the same
    # shapes, against the plain relu versions under the same bounds; the
    # control, the relu kernel against the softplus plain version, must
    # fail them.  A relu costs two operations (the bias and the max) where
    # a softplus100 costs eight; the layer into the head keeps its softplus.
    act_relu = 7 * 256 * 2.0 + 256 * 8.0
    for name, kern, plain, shape, f32_pp, bytes_pp, bytes_once in cases:
        kern_r, plain_r = functools.partial(kern, relu=True), functools.partial(plain, relu=True)
        got, ref, soft = kern_r(), plain_r(), plain()
        torch.cuda.synchronize()
        if got.shape != ref.shape or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{name}.relu: shape {tuple(got.shape)} or non-finite values")
        err = check_bf16_query(f"{name}.relu", got, ref)
        beyond = bf16_query_reading(got, soft)
        print(f"    control, the relu kernel against the softplus plain version: worst "
              f"{beyond[0]:.3f} of the bound, mean {beyond[1]:.3e} "
              f"{'fails the bounds: ok' if not beyond[2] else 'within: FAIL'}", flush=True)
        if beyond[2]:
            raise AssertionError(f"{name}.relu: the softplus control passes the bounds")
        ms = cuda_ms(torch, kern_r)
        n = got.numel()
        record(f"{name}.relu", err, ms, cuda_ms(torch, plain_r), shape,
               bound(2.0 * fq.TRUNK_MACS * n, (f32_pp - act + act_relu) * n,
                     bytes_pp * n + bytes_once),
               mean_abs_err=float((got - ref).abs().mean()),
               trunk_tflop_s=fq.TRUNK_FLOPS_PER_POINT * n / (ms * 1e-3) / 1e12,
               softplus_ms=results[name]["ms"])

    # 1 and 5 on every STRIDE-th MANO vertex (--sampler_knn_stride), in the
    # strided set's own tile order as build_scene makes it; the full set's
    # order for the strided set is refused
    s_verts, s_skin = verts[:, ::STRIDE].contiguous(), skin[:, ::STRIDE].contiguous()
    s_order = knn.tile_order(server.verts_c[0, ::STRIDE])
    Vs = s_verts.shape[1]
    try:
        knn.knn_inverse_warp(pts_s, s_verts, s_skin, tfs, order=order)
    except ValueError as e:
        print(f"  the full set's order for the strided set: refused ({e})", flush=True)
    else:
        raise AssertionError("knn_inverse_warp took the full set's order for the strided set")
    got_x, got_o = knn.knn_inverse_warp(pts_s, s_verts, s_skin, tfs, order=s_order)
    ref_x, ref_o = knn.inverse_warp_plain(pts_s, s_verts, s_skin, tfs)
    err = check_close(f"knn_inverse_warp x_c, V={Vs}", got_x, ref_x, 1e-5, 1e-5)
    if not torch.equal(got_o, ref_o):
        raise AssertionError("knn_inverse_warp (strided): outlier mask differs")
    sbytes = frame_bytes(B, Vs, J)
    cnt = search_counts(torch, f"knn_inverse_warp V={Vs}",
                        lambda: knn.knn_inverse_warp(pts_s, s_verts, s_skin, tfs, order=s_order))
    record("knn_inverse_warp.stride4", err,
           cuda_ms(torch, lambda: knn.knn_inverse_warp(pts_s, s_verts, s_skin, tfs,
                                                       order=s_order)),
           cuda_ms(torch, lambda: knn.inverse_warp_plain(pts_s, s_verts, s_skin, tfs)),
           f"B={B} P={pts_s.shape[1]} V={Vs}",
           bound(0, knn_needed(n_s, Vs, J) + n_s * (24 * J + 45), n_s * 25 + sbytes),
           search=cnt, library_note=no_library,
           brute_force_bound_ms=bound(0, knn_cost(n_s, Vs, J) + n_s * (24 * J + 45),
                                      n_s * 25 + sbytes)["bound_ms"])
    hand_s = (s_verts, s_skin, tfs, windows["right"], packs["right"])

    def strided_query():
        return fq.fused_hand_sampler_sdf_z(*rays, *hand_s, order=s_order)

    def strided_plain():
        return fq.hand_query_plain(pts_b, *hand_s).reshape(z_t.shape)

    got, ref = strided_query(), strided_plain()
    torch.cuda.synchronize()
    if got.shape != ref.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError("fused_hand_sampler_sdf_z (strided): shape or non-finite values")
    err = check_bf16_query(f"fused_hand_sampler_sdf_z V={Vs}", got, ref)
    ms = cuda_ms(torch, strided_query)
    n = got.numel()
    record("fused_hand_sampler_sdf_z.stride4", err, ms, cuda_ms(torch, strided_plain),
           f"B={B} P={P} S={S} V={Vs}",
           bound(2.0 * fq.TRUNK_MACS * n, (act + knn_needed(1, Vs, J) + 24 * J + 45) * n,
                 8.0 * n + wbytes + sbytes + B * P * 24),
           mean_abs_err=float((got - ref).abs().mean()),
           trunk_tflop_s=fq.TRUNK_FLOPS_PER_POINT * n / (ms * 1e-3) / 1e12)

    # 10, 11: the KNN blend kernels at the sampler warp's shape
    for name, fn in (("knn_blend_weights", knn.knn_blend_weights),
                     ("knn_blend_weights_t", knn.knn_blend_weights_t)):
        got_w, got_o = fn(pts_s, verts, skin, order=order)
        ref_w, ref_o = knn.blend_weights_plain(pts_s, verts, skin)
        if name.endswith("_t"):
            ref_w = ref_w.transpose(1, 2)
        err = check_close(f"{name} weights", got_w, ref_w, 1e-5, 1e-5)
        if not torch.equal(got_o, ref_o):
            raise AssertionError(f"{name}: outlier mask differs")
        if not torch.equal(got_w > 0, ref_w > 0):
            raise AssertionError(f"{name}: the neighbour sets differ")
        nbytes = n_s * (13 + 4 * J) + B * V * (12 + 4 * J)
        cnt = search_counts(torch, name, lambda: fn(pts_s, verts, skin, order=order))
        record(name, err, cuda_ms(torch, lambda: fn(pts_s, verts, skin, order=order)),
               cuda_ms(torch, lambda: knn.blend_weights_plain(pts_s, verts, skin)),
               f"B={B} P={pts_s.shape[1]} V={V}",
               bound(0, knn_needed(n_s, V, J), nbytes), search=cnt,
               library_note=no_library,
               brute_force_bound_ms=bound(0, knn_cost(n_s, V, J), nbytes)["bound_ms"])

    shade_checks(torch, scene, params, batch, zs["object"], xc, got_j.detach().contiguous(), dev,
                 record, results)
    render_checks(torch, seq, scene, params, dev, record)
    return results


def grad_reading(torch, got, ref) -> tuple:
    """(worst |got - ref| over the bound SHADE_GRAD_RTOL |ref| +
    SHADE_GRAD_ATOL max|ref|, share of elements beyond it, max |got - ref|);
    (inf, 1, inf) when ``got`` is not finite."""
    ref = ref.detach().float()
    got = got.detach().float()
    if not bool(torch.isfinite(got).all()):
        return math.inf, 1.0, math.inf
    d = (got - ref).abs()
    tol = SHADE_GRAD_RTOL * ref.abs() + SHADE_GRAD_ATOL * max(float(ref.abs().max()), 1e-30)
    ratio = d / tol
    return float(ratio.max()), float((ratio > 1.0).float().mean()), float(d.max())


def shade_tail_rows(fs, B: int, N: int, width: int = 64) -> list:
    """Flattened point indices within ``width`` of a place where the
    backward's work divides: a chunk's first and last points, the runs of
    CTAs whose partial column sums fused_shade_bwd_kernel_sums adds in turn,
    the blocks that split wgrad_kernel's sums (rounded to its pipeline
    steps), every frame boundary (where the rows kernel cuts the frame bias's
    sums), the last point."""
    total = B * N
    _, chunks = fs.bwd_chunks(total)
    edges = set(range(0, total + 1, N))
    for c0, rows, splits in chunks:
        per = -(-rows // splits)
        edges.update(range(c0, c0 + rows, -(-per // fs.WGRAD_STEP) * fs.WGRAD_STEP))
        edges.update(c0 + a * fs.BWD_ROWS for a, _ in fs.sum_runs(-(-rows // fs.BWD_ROWS)))
        edges.add(c0 + rows)
    return sorted({p for e in edges for p in range(max(0, e - width), min(total, e + width))})


def shade_grad_parts(fs, g: dict, tail) -> dict:
    """The backward's returned tensors cut into the parts checked on their
    own: x_c, J^-1 and (given) their ``tail`` rows, the frame bias, each
    matrix of the three packs, each bias row, the SDF head's row and bias."""
    tw, bw, cw = fs._unpack(g["tw_b"], g["tw_f"], g["bw_b"], g["cw_b"], g["cw_f"])
    parts = {"xc": g["xc"], "jinv9": g["jinv9"], "fb0": g["fb0"]}
    if tail is not None:
        parts.update({"xc tail": g["xc"].reshape(-1, 3)[tail],
                      "jinv9 tail": g["jinv9"].reshape(-1, 9)[tail]})
    for tag, pack in (("tw", tw), ("bw", bw), ("cw", cw)):
        for k, v in pack.items():
            if k in ("bias", "cbias"):
                parts.update({f"{tag}.{k}{i}": row for i, row in enumerate(v)})
            elif k not in ("bf16", "f32"):
                parts[f"{tag}.{k}"] = v
    return parts


def part_kind(name: str, n: int) -> str:
    """The key of a part of ``n`` elements in GRAD_LIMITS and LOSS_LIMITS."""
    if name == "fb0":
        return "frame bias"
    if name in COLOUR_PARTS:
        return "colour"
    return "point" if name.startswith(("xc", "jinv9")) or n == 1 else "trunk"


def grad_table(read: dict, limits: dict, show, control: str) -> tuple:
    """Holds each part's kernel reading, and the ``control``'s, to the
    part's (share, cap) in ``limits``; prints a line for each part in
    ``show`` and each that either fails.  Returns (parts the kernel fails,
    parts the control fails)."""
    failed, caught = [], []
    for k, (w, sh, _) in read["kernel"].items():
        share, cap = limits[k]
        ok = sh <= share and w <= cap
        cw, csh, _ = read[control][k]
        if not ok:
            failed.append(k)
        if not (csh <= share and cw <= cap):
            caught.append(k)
        if k in show or not ok or k in caught:
            print(f"      {k}: " + " | ".join(f"{read[lab][k][0]:.3f} ({read[lab][k][1]:.1e})"
                                         for lab in ("kernel", "f64 products", control)
                                         if lab in read)
                  + f"; limit {cap:g} ({share:g}) {'ok' if ok else 'FAIL'}", flush=True)
    return failed, caught


def shade_grad_check(torch, fs, args, cts, tail, kinds: dict = GRAD_LIMITS) -> dict:
    """One backward of row 7, part by part: the kernel, the plain version
    with float64 products and without its bf16 roundings, each against the
    plain version, held to ``kinds``' limits, which the kernel and the
    float64 reading must pass and the unrounded control must fail on some
    part.  Returns {reading: {part: (worst, share, max|d|)}, "limits": ...,
    "failed": [...], "caught": [...], "ref": the plain version's
    gradients}."""
    from unittest import mock

    def plain():
        return fs.shade_train_bwd_plain(*args, *cts)

    ref = plain()
    got = fs.shade_train_bwd_cuda(*args, *cts)
    torch.cuda.synchronize()
    with products_in_f64(torch):
        f64 = plain()
    with mock.patch.object(fs, "_bf", lambda x: x):
        unrounded = plain()
    tail_t = torch.tensor(tail, device=args[0].device)
    ref_p = shade_grad_parts(fs, ref, tail_t)
    out = {}
    for lab, g in (("kernel", got), ("f64 products", f64), ("unrounded", unrounded)):
        parts = shade_grad_parts(fs, g, tail_t)
        out[lab] = {k: grad_reading(torch, parts[k], r) for k, r in ref_p.items()}
    out["limits"] = {k: kinds[part_kind(k, r.numel())] for k, r in ref_p.items()}
    print(f"    backward, {len(ref_p)} parts, worst |d| / bound (share beyond) of the kernel | f64 "
          f"products | unrounded, and the part's limit:", flush=True)
    out["failed"], out["caught"] = grad_table(out, out["limits"], ref_p, "unrounded")
    # a limit must also pass the sound reading, or it would fail a kernel
    # that only sums in another order
    out["failed"] += [f"{k} (the f64 reading)" for k, (w, sh, _) in out["f64 products"].items()
                      if not (sh <= out["limits"][k][0] and w <= out["limits"][k][1])]
    out["ref"] = ref
    print(f"    the unrounded control fails {len(out['caught'])} of {len(ref_p)} parts "
          f"{'ok' if out['caught'] else 'FAIL'}", flush=True)
    # the worst of each kind of part, what SHADE_LIMITS' rule reads
    for kind in dict.fromkeys(part_kind(k, r.numel()) for k, r in ref_p.items()):
        names = [k for k, r in ref_p.items() if part_kind(k, r.numel()) == kind]
        print(f"    {kind}, worst (share beyond) of {len(names)} parts: " + " | ".join(
            f"{max(out[lab][k][0] for k in names):.3f} ({max(out[lab][k][1] for k in names):.2e})"
            for lab in ("kernel", "f64 products", "unrounded")), flush=True)
    return out


def shade_case(torch, fs, fr, label: str, args, gen, dev, errs: dict, limits) -> list:
    """Row 7 at one case's inputs (``args``, the op's arguments): the forward
    kernel against its plain version, then the backward part by part under
    the JAX package's test loss (``limits[1]``), under seeded cotangents and
    under those with only the tail rows carrying them (``limits[0]``), with
    the controls that must fail.  Records the readings in ``errs``; returns
    the failures."""
    failed = []
    Bc, N = args[0].shape[:2]
    print(f"  fused_shade_train, {label} (B={Bc} N={N}):", flush=True)
    got, ref = fs.shade_train_fwd_cuda(*args), fs.shade_train_plain(*args)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        if g.shape != r.shape or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"fused_shade_train.fwd: shape {tuple(g.shape)} or non-finite")
    e = {"sdf": check_bf16_query("  sdf", got[0], ref[0]),
         "rgb": check_close("  rgb", got[1], ref[1], 0.0, RENDER_RGB)}
    d_n = (got[2] - ref[2]).abs().flatten()
    p99, n_max = float(d_n.quantile(0.99)), float(d_n.max())
    ok = p99 <= RENDER_NRM_P99 and n_max <= RENDER_NRM_MAX
    print(f"    normal: p99 |d| {p99:.3e} (tol {RENDER_NRM_P99}), max {n_max:.3e} "
          f"(tol {RENDER_NRM_MAX}) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("fused_shade_train.fwd: normals disagree with the plain version")
    e["normal"] = n_max
    errs["fwd"][label] = e
    tail = shade_tail_rows(fs, Bc, N)
    # the cotangents of the JAX package's test loss, sum sdf^2 + |rgb|^2
    # + |n_x|, which do not cancel over the points
    g_nrm = torch.zeros_like(ref[2])
    g_nrm[..., 0] = torch.sign(ref[2][..., 0])
    print("    under the JAX test's loss:", flush=True)
    res_l = shade_grad_check(torch, fs, args, (2.0 * ref[0], 2.0 * ref[1], g_nrm), tail,
                             limits[1])
    failed += [f"{label} {k} (the JAX test's loss)" for k in res_l["failed"]]
    cts = [torch.randn(s, generator=gen, device=dev) for s in ((Bc, N), (Bc, N, 3), (Bc, N, 3))]
    print("    under seeded cotangents:", flush=True)
    res = shade_grad_check(torch, fs, args, cts, tail, limits[0])
    # the tail rows alone: with the other points' cotangents zero, every
    # sum over the points holds only theirs
    mask = torch.zeros(Bc * N, device=dev)
    mask[tail] = 1.0

    def masked(m):
        return [c * m.view((Bc, N) + (1,) * (c.dim() - 2)) for c in cts]

    # control: the first 16 points of each frame (N // 196 beyond 12,544,
    # see SHADE_LIMITS) summed into the frame before must fail the frame
    # bias's limits
    k_first = 16 if N <= 12544 else N // 196
    first = torch.zeros((Bc, N), device=dev)
    first[1:, :k_first] = 1.0
    moved = fs.shade_train_bwd_plain(*args, *masked(first.view(-1)))["fb0"]
    ref_fb = res["ref"]["fb0"]
    w, sh, _ = grad_reading(torch, ref_fb - moved + moved.roll(-1, 0), ref_fb)
    share, cap = res["limits"]["fb0"]
    ok = sh > share or w > cap
    print(f"    control, each frame's first {k_first} points summed into the frame before: fb0 "
          f"{w:.3f} ({sh:.1e}), limit {cap:g} ({share:g}) {'fails it, ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        failed.append(f"{label}: the frame bias's limits pass misplaced frame boundaries")

    print(f"    the {len(tail)} tail rows alone (cotangents zero elsewhere):", flush=True)
    res_t = shade_grad_check(torch, fs, args, masked(mask), tail, limits[0])
    failed += [f"{label} {k}" for k in res["failed"]]
    failed += [f"{label} {k} (tail rows alone)" for k in res_t["failed"]]
    if not (res["caught"] and res_t["caught"]):
        failed.append(f"{label}: the limits pass the unrounded control")
    kern = res["kernel"]
    top = max((k for k in kern if k != "fb0"), key=lambda k: kern[k][0])
    errs["bwd"][label] = {
        "worst_part": top, "worst": kern[top][0], "fb0": kern["fb0"][0],
        "sound_worst": max(v[0] for v in res["f64 products"].values()),
        "tail_alone_worst": max(v[0] for v in res_t["kernel"].values()),
        "jax_loss_worst": max(v[0] for v in res_l["kernel"].values()),
        "max_abs_err": max(v[2] for v in kern.values())}
    if N % fr.TILE:
        # control: the plain version without the last partial 16-point
        # block must fail the limits, or they could not see a kernel that
        # dropped one
        k = (Bc * N) % 16 or 16
        drop = mask.clone()
        drop[-k:] = 0.0
        ref_t = shade_grad_parts(fs, fs.shade_train_bwd_plain(*args, *masked(mask)), None)
        ctl = shade_grad_parts(fs, fs.shade_train_bwd_plain(*args, *masked(drop)), None)
        caught = []
        for p, r in ref_t.items():
            w, sh, _ = grad_reading(torch, ctl[p], r)
            share, cap = res_t["limits"][p]
            if sh > share or w > cap:
                caught.append(p)
        print(f"    control, the last {k} points dropped: the limits fail it on "
              f"{len(caught)} parts ({', '.join(caught[:6])}, ...) "
              f"{'ok' if caught else 'FAIL'}", flush=True)
        if not caught:
            failed.append(f"{label}: the limits pass a dropped last block")
    return failed


def shade_checks(torch, scene, params, batch, z_obj, xc_hand, jinv_hand, dev, record,
                 results) -> None:
    """Phase 3, row 7: the fused training shade's forward and backward
    kernels against their plain versions, at the grad stage's real canonical
    points and J^-1 of both nodes (the sampler's z tables of one step, 10
    frames x 12,544 points) and at an N that is no multiple of the kernel's
    128-point tile; seeded cotangents."""
    from hold_tpu_torch.models.holdnet import _rays
    from hold_tpu_torch.models.mlp import _apply_linear, resolve_weight_norm
    from hold_tpu_torch.models.nodes import _mano_pose, _object_pose
    from hold_tpu_torch.models.object_model import object_deform
    from hold_tpu_torch.ops import fused_query as fq
    from hold_tpu_torch.ops import fused_render as fr
    from hold_tpu_torch.ops import fused_shade as fs
    from hold_tpu_torch.utils.transforms import inverse_mat3

    B = xc_hand.shape[0]
    ray_dirs, cam_loc = _rays(batch)
    cases = {}
    with torch.no_grad():
        for nid in ("right", "object"):
            plans = scene.plans[nid]
            imp = resolve_weight_norm(params[nid]["implicit"])
            rend = resolve_weight_norm(params[nid]["rendering"])
            tw = fq.pack_trunk_weights(imp, plans.implicit)
            packs = (fq.embed_window(plans.implicit, sum(plans.barf_cfg) // 2, plans.barf_cfg, dev),
                     tw, fr.pack_trunk_transposed(imp, plans.implicit, tw),
                     fr.pack_color_weights(rend, imp))
            if nid == "right":
                _, cond = _mano_pose(params[nid], scene.servers[nid], batch, 25)
                fb0 = fr.frame_bias0(rend, _apply_linear(rend["lin_pose"], cond))
                xc, jinv = xc_hand, jinv_hand
            else:
                tfs = _object_pose(params[nid], scene.servers[nid], batch).obj_tfs
                pts = (cam_loc[:, None] + z_obj[..., None] * ray_dirs[:, None]).reshape(B, -1, 3)
                xc = object_deform(pts, tfs, inverse=True).contiguous()
                jinv = inverse_mat3(tfs[:, :3, :3]).reshape(B, 1, 9).expand(
                    B, xc.shape[1], 9).contiguous()
                tc = params[nid]["frame_latent"][batch["frame_idx"]]
                fb0 = fr.frame_bias0(rend, torch.zeros((B, 8), device=dev), tc)
            cases[nid] = (xc, jinv, fb0.detach().contiguous(), *packs)
        n_pad = cases["right"][0].shape[1] - 61
        cases[f"right N={n_pad}"] = (cases["right"][0][:, :n_pad].contiguous(),
                                     cases["right"][1][:, :n_pad].contiguous(),
                                     *cases["right"][2:])
    gen = torch.Generator(dev).manual_seed(7)
    errs = {"fwd": {}, "bwd": {}}
    failed = []
    for label, args in cases.items():
        failed += shade_case(torch, fs, fr, label, args, gen, dev, errs,
                             (GRAD_LIMITS, LOSS_LIMITS))
    args = cases["right"]
    n = args[0].shape[0] * args[0].shape[1]
    cts = [torch.randn(s, generator=gen, device=dev) for s in ((B, n // B), (B, n // B, 3),
                                                               (B, n // B, 3))]
    wbytes = ((fq.W_TOTAL + fr.T_TOTAL + fr.C_TOTAL) * 2.0 + (fq.F_TOTAL + fr.CB_TOTAL) * 4.0
              + B * 256 * 4.0)
    act = 8 * 256 * 10.0 + 8 * 256 + 4 * 256 * 2 + 60  # activations, sigmoids, relus
    shape = f"B={B} N={n // B} (hand; also the object and N={n // B - 61})"
    # the forward timed with its weight stream made, as the op makes it once a call
    slabs = fs.tile_shade_bwd(*args[4:])
    for name, kern, plain, macs, f32_pp, bytes_pp, bytes_once in (
        ("fused_shade_train.fwd", lambda: fs.shade_train_fwd_cuda(*args, slabs),
         lambda: fs.shade_train_plain(*args), fs.SHADE_FWD_MACS, act, 76.0, wbytes),
        ("fused_shade_train.bwd", lambda: fs.shade_train_bwd_cuda(*args, *cts),
         lambda: fs.shade_train_bwd_plain(*args, *cts), fs.SHADE_BWD_MACS, 3 * act, 124.0,
         wbytes * 3),
    ):
        ms = cuda_ms(torch, kern)
        part = errs[name.split(".")[1]]
        worst = max(e["max_abs_err"] if "max_abs_err" in e else max(e.values())
                    for e in part.values())
        record(name, worst, ms, cuda_ms(torch, plain, fill_ms=0.0), shape,
               bound(2.0 * macs * n, f32_pp * n, bytes_pp * n + bytes_once), errors=part,
               tflop_s=2.0 * macs * n / (ms * 1e-3) / 1e12)
    # the backward's device time by kernel
    split = kernel_split(torch, "fused_shade_train.bwd",
                         lambda: fs.shade_train_bwd_cuda(*args, *cts),
                         ("fused_shade_bwd_kernel_sums", "fused_shade_bwd_kernel", "wgrad_kernel"))
    if split:
        results["fused_shade_train.bwd"]["split_ms"] = split
    if failed:
        raise AssertionError(f"fused_shade_train.bwd disagrees with its plain version: {failed}")


def fast_config(data_root: str):
    """``-f`` through the training CLI's parser: (args, cfg), the model's
    sampler shortened as ``run_training`` shortens it."""
    from hold_tpu_torch.train import FAST_SAMPLER
    from hold_tpu_torch.utils.config import parse_args

    args, cfg = parse_args(["--case", "synthetic", "--data_root", data_root, "--log_root",
                            os.path.join(ROOT, "logs", "chip_smoke"), "--exp_key",
                            "chip_smoke_fast", "-f", "--mute"])
    cfg["model"]["ray_sampler"] = dict(cfg["model"]["ray_sampler"], **FAST_SAMPLER)
    return args, cfg


def fast_shape_checks(torch, seq, data_root: str, dev, results) -> None:
    """Phase 3 at the shapes that ``-f`` gives rows 5-6 and no other check
    does: the ``-f`` scene as ``run_training`` builds it (the sampler at 16 /
    32 / 8 samples, 2 rounds) on 10 frames x 8 rays.  Every call that one
    step's sampler makes of the fused query kernels, at its own inputs,
    against the plain version and against the layer-by-layer query (the
    ``--no_fused_sampler`` path, which the JAX package takes at these sample
    counts), under the fused query's bounds; against the layer-by-layer
    query, which rounds to bf16 at other places, the mean too is scaled by
    max(1, |sdf|): the object's far samples reach |sdf| ~ 30, where a bf16
    step is 0.125.  Row 7 at these shapes: phase 4's agreement on the ``-f``
    scene."""
    import numpy as np

    from hold_tpu_torch.models import nodes
    from hold_tpu_torch.models.holdnet import build_scene, init_scene_params, sample_all_z
    from hold_tpu_torch.models.mlp import cast_tree, resolve_weight_norm
    from hold_tpu_torch.models.object_model import object_deform
    from hold_tpu_torch.ops import fused_query as fq
    from hold_tpu_torch.ops import knn
    from hold_tpu_torch.train import FAST_SAMPLER, batch_to_device

    args, cfg = fast_config(data_root)
    scene = build_scene(dict(cfg["model"], scene_bounding_sphere=seq.scene_bounding_sphere),
                        dict(args), seq.scene_data(), dev)
    params = init_scene_params(torch.Generator().manual_seed(0), scene, seq.scene_data())
    batch = batch_to_device(seq.sample_tempo_batch(np.random.RandomState(0), BATCH_SIZE, 1,
                                                   int(args["num_sample"])), dev)
    B, P = batch["uv"].shape[:2]
    step, epoch = 300, 25
    print(f"  -- the -f shapes: 10 frames x {P} rays, samples {FAST_SAMPLER}", flush=True)
    calls = []
    with recorded_queries(calls):
        sample_all_z(params, scene, batch, torch.Generator(dev).manual_seed(0), step, epoch)
    with torch.no_grad():
        obj_tfs = nodes._object_pose(params["object"], scene.servers["object"], batch).obj_tfs
        nets = {nid: cast_tree(resolve_weight_norm(params[nid]["implicit"]), torch.bfloat16)
                for nid in ("right", "object")}

    @torch.no_grad()
    def layer(call):
        kind, a, _, _ = call
        nid = "right" if kind == "hand" else "object"
        plans = scene.plans[nid]
        pts = fq.points_from_rays_z(*a[:3])
        if kind == "hand":
            x_c, _ = knn.knn_inverse_warp(pts, *a[3:6], K=plans.knn_k, max_dist=plans.max_dist,
                                          order=plans.tile_order)
        else:
            x_c = object_deform(pts, obj_tfs, inverse=True)
        return nodes._bf16_trunk_sdf(nets[nid], plans, x_c.reshape(-1, 3), step).reshape(
            a[2].shape)

    errs = {}
    for i, call in enumerate(calls):
        kind, a, _, got = call
        name, shape = f"fused_{kind}_sampler_sdf_z", f"B={B} P={P} S={a[2].shape[2]}"
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{name} {shape}: non-finite values")
        errs.setdefault(name, {})[f"call {i} {shape}"] = {
            "plain": check_bf16_query(f"{name} call {i} {shape} vs plain", got,
                                      plain_query(torch, call, dev)),
            "layer": check_bf16_query(f"{name} call {i} {shape} vs layer by layer", got,
                                      layer(call), scaled_mean=True)}
    if len(errs) != 2:
        raise AssertionError(f"the -f sampler called {sorted(errs)} only")
    for name, e in errs.items():
        results[name]["fast"] = e


@contextlib.contextmanager
def recorded_shades(torch, calls: list):
    """While open, every call of the nodes' fused training shade (row 7's
    op) appends its arguments, detached and contiguous as the op hands them
    to its kernels, to ``calls``, in the order the grad stage made them."""
    from hold_tpu_torch.models import nodes

    op = nodes.fused_shade_train

    def detached(x):
        if isinstance(x, dict):
            return {k: detached(v) for k, v in x.items()}
        return x.detach().contiguous() if torch.is_tensor(x) else x

    def call(*a):
        calls.append(tuple(detached(x) for x in a))
        return op(*a)

    nodes.fused_shade_train = call
    try:
        yield
    finally:
        nodes.fused_shade_train = op


def fast_shade_checks(torch, seq, data_root: str, dev, results) -> None:
    """Phase 3, row 7 at the shapes ``-f`` gives it: the arguments each node
    hands the op in one ``-f`` grad stage (10 frames x 8 rays x 26 samples,
    N = 208 points a frame), recorded, through ``shade_case`` under the
    limits derived at that N (SHADE_LIMITS)."""
    import numpy as np

    from hold_tpu_torch.models.holdnet import (
        build_scene, empty_object_mesh_state, holdnet_forward, init_scene_params, sample_all_z,
        sample_step_draws,
    )
    from hold_tpu_torch.ops import fused_render as fr
    from hold_tpu_torch.ops import fused_shade as fs
    from hold_tpu_torch.train import batch_to_device

    args, cfg = fast_config(data_root)
    scene = build_scene(dict(cfg["model"], scene_bounding_sphere=seq.scene_bounding_sphere),
                        dict(args), seq.scene_data(), dev)
    params = init_scene_params(torch.Generator().manual_seed(0), scene, seq.scene_data())
    batch = batch_to_device(seq.sample_tempo_batch(np.random.RandomState(0), BATCH_SIZE, 1,
                                                   int(args["num_sample"])), dev)
    B, P = batch["uv"].shape[:2]
    step, epoch = 300, 25  # hand loss targets active, pose conditioning on
    gen = torch.Generator(dev).manual_seed(0)
    calls = []
    with torch.no_grad():
        zs = sample_all_z(params, scene, batch, gen, step, epoch)
    with recorded_shades(torch, calls):
        holdnet_forward(params, scene, batch, empty_object_mesh_state(dev),
                        sample_step_draws(scene, B, P, gen), step, epoch, zs)
    if len(calls) != len(scene.node_ids):
        raise AssertionError(f"the -f grad stage shaded {len(calls)} times")
    gen = torch.Generator(dev).manual_seed(8)
    errs = {"fwd": {}, "bwd": {}}
    failed = []
    for nid, a in zip(scene.node_ids, calls):
        N = a[0].shape[1]
        if N not in SHADE_LIMITS:
            raise AssertionError(f"row 7 at N = {N}: no limits derived at that N")
        failed += shade_case(torch, fs, fr, f"-f {nid}", a, gen, dev, errs, SHADE_LIMITS[N])
    results["fused_shade_train.fwd"]["fast"] = errs["fwd"]
    results["fused_shade_train.bwd"]["fast"] = errs["bwd"]
    if failed:
        raise AssertionError(f"fused_shade_train at -f's shapes disagrees with its plain "
                             f"version: {failed}")


# the JAX bench's step shapes (bench.py: 10 frames x rays // 10 a frame) past
# 1,280 rays, as rays a frame; a grad stage hands row 7 98 samples a ray, so
# N = 50,176, 100,352 and 200,704 points a frame
BENCH_RAYS = (512, 1024, 2048)
# the plain versions at those shapes run on a call's first frames only, as
# many as hold this many points (at least 2, so that a frame boundary lies
# among them): row 7's plain backward keeps ~70 (points, 256) float32
# tensors, ~29 GB at 401,408 points
PLAIN_POINTS = 401_408


def plain_frames(n: int) -> int:
    """Frames of a call at ``n`` points a frame that its plain version runs on."""
    return max(2, min(10, PLAIN_POINTS // n))


def bench_shape_checks(torch, seq, args, cfg, dev, results) -> None:
    """Phase 3 at the JAX bench's step shapes (BENCH_RAYS): for each, the
    arguments each node's grad stage hands row 7 (recorded, the BARF window
    half open and the pose conditioning on), held part by part through
    ``shade_case`` under SHADE_LIMITS at that N on the call's first
    ``plain_frames(N)`` frames, and the kernels on the whole call giving
    those frames' per-point outputs bit for bit; at the largest, rows 1-6
    on the whole call against their plain versions on its first frames
    under their tolerances: row 1 on the sampler's first round (as proposal
    mode warps it), rows 2-3 forward and backward and row 4 on the object's
    buffer at the grad stage's points, rows 5-6 at 128 samples a ray."""
    import numpy as np

    from hold_tpu_torch.models.holdnet import (
        build_scene, empty_object_mesh_state, holdnet_forward, init_scene_params, sample_all_z,
        sample_step_draws,
    )
    from hold_tpu_torch.ops import fused_render as fr
    from hold_tpu_torch.ops import fused_shade as fs
    from hold_tpu_torch.train import batch_to_device

    opt_model = dict(cfg["model"], scene_bounding_sphere=seq.scene_bounding_sphere)
    scene = build_scene(opt_model, dict(args), seq.scene_data(), dev)
    params = init_scene_params(torch.Generator().manual_seed(0), scene, seq.scene_data())
    step, epoch = sum(scene.plans["right"].barf_cfg) // 2, 25
    failed = []
    for rays in BENCH_RAYS:
        batch = batch_to_device(seq.sample_tempo_batch(np.random.RandomState(0), BATCH_SIZE, 1,
                                                       rays), dev)
        B, P = batch["uv"].shape[:2]
        gen = torch.Generator(dev).manual_seed(0)
        with torch.no_grad():
            zs = sample_all_z(params, scene, batch, gen, step, epoch)
        calls = []
        with recorded_shades(torch, calls):
            holdnet_forward(params, scene, batch, empty_object_mesh_state(dev),
                            sample_step_draws(scene, B, P, gen), step, epoch, zs)
        if len(calls) != len(scene.node_ids):
            raise AssertionError(f"the grad stage at {B * P} rays shaded {len(calls)} times")
        torch.cuda.empty_cache()
        print(f"  -- {B * P} rays a step (10 frames x {P})", flush=True)
        if rays == BENCH_RAYS[-1]:
            bench_row_checks(torch, scene, params, batch, zs, dev, results)
        gen = torch.Generator(dev).manual_seed(9)
        errs = {"fwd": {}, "bwd": {}}
        for nid, a in zip(scene.node_ids, calls):
            N = a[0].shape[1]
            if N not in SHADE_LIMITS:
                raise AssertionError(f"row 7 at N = {N}: no limits derived at that N")
            b = plain_frames(N)
            sub = tuple(x[:b].contiguous() for x in a[:3]) + tuple(a[3:])
            label = f"{B * P} rays {nid}"
            failed += whole_call_check(torch, fs, a, sub, gen, dev, label)
            print(f"  row 7 at N = {N}, the plain versions on the first {b} of {B} frames",
                  flush=True)
            failed += shade_case(torch, fs, fr, label, sub, gen, dev, errs, SHADE_LIMITS[N])
            torch.cuda.empty_cache()
        for k in ("fwd", "bwd"):
            results[f"fused_shade_train.{k}"].setdefault("bench", {}).update(errs[k])
        del calls, zs
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"fused_shade_train at the bench's shapes disagrees with its plain "
                             f"version: {failed}")


def error_bound_ops(R: int, S: int, ne: int, iters: int) -> float:
    """Operations of one error-bound step on R rays whose merged table holds
    S samples: 2 + iters error bounds over S - 1 intervals (the bisection's,
    and the pdf's pass), ~27 operations an interval each, an exponential
    counted as one; the sort of the merge, (S log2 S)^2 / 2 comparisons
    at most, is not counted."""
    return float(R) * (S - 1) * (iters + 2) * 27.0


def error_bound_checks(torch, seq, args, cfg, dev, results) -> None:
    """Phase 3: the error-bound sampler's two kernels on what one sampler
    stage hands them, at the render chunk (4,096 rays, no generator, the
    trunk's fused query) and at 20,480 rays (a seeded generator): every
    round and final step recorded, the launches counted (4 rounds and 1
    final a node), each call held against the plain steps on the card at
    its own inputs (the merged table bit for bit, beta on at most 0.5 % of
    the rays apart by more than rounding, the samples' 99th percentile of
    |dz| within 1e-3 scene radii), and both timed by CUDA events, summed
    over a node's calls."""
    import numpy as np

    from hold_tpu_torch.models.holdnet import build_scene, init_scene_params, sample_all_z
    from hold_tpu_torch.ops import error_bound as eb
    from hold_tpu_torch.render import ray_sampler as rs
    from hold_tpu_torch.train import batch_to_device

    opt_model = dict(cfg["model"], scene_bounding_sphere=seq.scene_bounding_sphere)
    scene = build_scene(opt_model, dict(args), seq.scene_data(), dev)
    params = init_scene_params(torch.Generator().manual_seed(0), scene, seq.scene_data())
    scfg = scene.sampler_cfg
    radius = scfg.scene_bounding_sphere
    step = sum(scene.plans["right"].barf_cfg) // 2
    failed = []
    for label, pairs, rays, seed in (("render chunk", 1, 2048, None), ("20480", 5, 2048, 0)):
        batch = batch_to_device(seq.sample_tempo_batch(np.random.RandomState(0), pairs, 1, rays),
                                dev)
        calls = []
        real = {"round": rs.error_bound_round, "final": rs.error_bound_final}

        def recording(kind):
            def fn(*a):
                calls.append((kind, a))
                return real[kind](*a)
            return fn

        rs.error_bound_round, rs.error_bound_final = recording("round"), recording("final")
        eb.reset_launch_counts()
        try:
            with torch.no_grad():
                gen = None if seed is None else torch.Generator(dev).manual_seed(seed)
                sample_all_z(params, scene, batch, gen, step, 25)
        finally:
            rs.error_bound_round, rs.error_bound_final = real["round"], real["final"]
        torch.cuda.synchronize()
        nodes = len(scene.node_ids)
        want = {"eb_round": nodes * (scfg.max_total_iters - 1), "eb_final": nodes}
        if eb.LAUNCHES != want:
            failed.append(f"{label}: launches {eb.LAUNCHES}, expected {want}")
        per_node = len(calls) // nodes
        R = calls[0][1][0].shape[0]
        for n, nid in enumerate(scene.node_ids):
            mine = calls[n * per_node:(n + 1) * per_node]
            kernel_ms = plain_ms = bound_ms = 0.0
            worst_p99, flipped = 0.0, torch.zeros(R, dtype=torch.bool, device=dev)
            for kind, a in mine:
                kern = eb.eb_round if kind == "round" else eb.eb_final
                plain = rs.error_bound_round_plain if kind == "round" else \
                    rs.error_bound_final_plain
                got, ref = kern(*a), plain(*a)
                if kind == "round":
                    if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
                        failed.append(f"{label} {nid}: a round's merge differs")
                    flipped |= (got[2] - ref[2]).abs() > 1e-5 * ref[2].abs()
                    got, ref = got[3], ref[3]
                dz = (got - ref).abs().flatten().double().cpu()
                worst_p99 = max(worst_p99, float(torch.quantile(dz, 0.99)))
                if not bool(torch.isfinite(got).all()):
                    failed.append(f"{label} {nid}: non-finite {kind} output")
                kernel_ms += cuda_ms(torch, lambda: kern(*a))
                plain_ms += cuda_ms(torch, lambda: plain(*a))
                # floats a ray: the table and the new samples in, beta in and
                # out; a round writes the merged table and its samples, the
                # last step reads its draws and writes the final set
                S, ne = a[0].shape[1], 0 if a[2] is None else a[2].shape[1]
                u = a[6]
                if kind == "round":
                    floats = 2 * (S + ne) + 2 + (2 * (S + ne) if ne else 0) + u.shape[-1]
                else:
                    idx = a[7]
                    floats = (2 * (S + ne) + 1 + (u.shape[-1] if u.dim() == 2 else 0)
                              + u.shape[-1] + 2 + (0 if idx is None else idx.shape[0]))
                nbytes = 4.0 * R * floats
                bound_ms += bound(0, error_bound_ops(R, S + ne, ne, scfg.beta_iters),
                                  nbytes)["bound_ms"]
            share = float(flipped.float().mean())
            print(f"  error_bound {label} {nid} (R={R}, {len(mine)} calls): kernel "
                  f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                  f"(operations); worst p99 |dz| {worst_p99:.3e}, beta apart on "
                  f"{share:.4%} of the rays", flush=True)
            if worst_p99 > 1e-3 * radius or share > 5e-3:
                failed.append(f"{label} {nid}: p99 {worst_p99:.3e}, beta apart {share:.4%}")
            results[f"error_bound.{'render' if seed is None else 'train'}.{nid}"] = {
                "max_abs_err": worst_p99, "ms": kernel_ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": "operations", "library_ms": None,
                "shape": f"R={R} S<={scfg.N_samples_eval * scfg.max_total_iters}",
                "beta_apart": share}
        del calls, batch
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"error-bound kernels: {failed}")


def whole_call_check(torch, fs, args, sub, gen, dev, label: str) -> list:
    """Row 7's kernels on a whole call (``args``) against the same kernels on
    its first frames (``sub``, what ``shade_case`` holds to the plain
    version): the forward's outputs and the backward's per-point gradients
    (x_c, J^-1) of those frames bit for bit equal, everything finite; the
    whole call's times.  Returns the failures."""
    B, N = args[0].shape[:2]
    b = sub[0].shape[0]
    cts = [torch.randn(s, generator=gen, device=dev) for s in ((B, N), (B, N, 3), (B, N, 3))]
    fwd, fwd_s = fs.shade_train_fwd_cuda(*args), fs.shade_train_fwd_cuda(*sub)
    bwd = fs.shade_train_bwd_cuda(*args, *cts)
    bwd_s = fs.shade_train_bwd_cuda(*sub, *(c[:b].contiguous() for c in cts))
    torch.cuda.synchronize()
    finite = all(bool(torch.isfinite(t).all()) for t in (*fwd, *bwd.values()))
    same = all(bool(torch.equal(w[:b], s)) for w, s in zip(fwd, fwd_s)) and all(
        bool(torch.equal(bwd[k][:b], bwd_s[k])) for k in ("xc", "jinv9"))
    ms = (cuda_ms(torch, lambda: fs.shade_train_fwd_cuda(*args), fill_ms=0.0),
          cuda_ms(torch, lambda: fs.shade_train_bwd_cuda(*args, *cts), fill_ms=0.0))
    ok = finite and same
    print(f"  fused_shade_train, {label}: the whole call (B={B} N={N}, "
          f"{len(fs.bwd_chunks(B * N)[1])} backward chunks) finite {finite}, its first {b} "
          f"frames' outputs and per-point gradients bit for bit those of the call on them "
          f"alone {same}; fwd {ms[0]:.3f} ms, bwd {ms[1]:.3f} ms {'ok' if ok else 'FAIL'}",
          flush=True)
    return [] if ok else [f"{label}: the whole call"]


def bench_row_checks(torch, scene, params, batch, zs, dev, results) -> None:
    """Rows 1-6 at one bench shape (see ``bench_shape_checks``): each kernel
    on the whole call, its plain version on the first frames, under the
    tolerances phase 3 holds it to at 1,280 rays; the kernel's time on the
    whole call."""
    from hold_tpu_torch.models.holdnet import _rays, empty_object_mesh_state
    from hold_tpu_torch.models.mlp import resolve_weight_norm
    from hold_tpu_torch.models.nodes import _mano_pose, _object_pose
    from hold_tpu_torch.ops import fused_query as fq
    from hold_tpu_torch.ops import knn, point_mesh
    from hold_tpu_torch.render.ray_sampler import uniform_z_vals
    from hold_tpu_torch.render.volsdf import get_sphere_intersections
    from hold_tpu_torch.utils.transforms import inverse_mat3

    B, P = batch["uv"].shape[:2]
    server = scene.servers["right"]
    order = scene.plans["right"].tile_order
    with torch.no_grad():
        srv_out, _ = _mano_pose(params["right"], server, batch, 0)
        obj_tfs = _object_pose(params["object"], scene.servers["object"], batch).obj_tfs
    tfs, verts = srv_out.tfs.detach().contiguous(), srv_out.verts.detach().contiguous()
    verts_c = server.verts_c.expand(B, -1, -1).contiguous()
    skin = server.skin_weights_c.expand(B, -1, -1).contiguous()
    ray_dirs, cam_loc = _rays(batch)
    far = get_sphere_intersections(cam_loc, ray_dirs, scene.sampler_cfg.scene_bounding_sphere)[:, 1:]
    z0 = uniform_z_vals(None, ray_dirs, cam_loc, torch.zeros_like(far), far,
                        scene.sampler_cfg.N_samples_eval)
    S = z0.shape[1]
    z_t = z0.reshape(B, P, S).contiguous()
    rays = (ray_dirs.contiguous(), cam_loc.contiguous(), z_t)
    pts_s = fq.points_from_rays_z(*rays).contiguous()
    pts_g = (cam_loc[:, None] + zs["right"][..., None] * ray_dirs[:, None]).reshape(
        B, -1, 3).contiguous()
    rng = torch.Generator(dev).manual_seed(1)

    def note(name, err, fn, shape, frames):
        ms = cuda_ms(torch, fn, fill_ms=0.0)
        results[name].setdefault("bench", {})[shape] = {"max_abs_err": err, "ms": ms,
                                                        "plain_frames": frames}
        print(f"  {name} {shape}: kernel {ms:.4f} ms on the whole call; the plain version on "
              f"its first {frames} frames", flush=True)

    # 1: the sampler's warp, one round of 128 samples
    b = plain_frames(pts_s.shape[1])
    got_x, got_o = knn.knn_inverse_warp(pts_s, verts, skin, tfs, order=order)
    ref_x, ref_o = knn.inverse_warp_plain(pts_s[:b], verts[:b], skin[:b], tfs[:b])
    err = check_close("knn_inverse_warp x_c", got_x[:b], ref_x, 1e-5, 1e-5)
    if not torch.equal(got_o[:b], ref_o):
        raise AssertionError("knn_inverse_warp: outlier mask differs")
    note("knn_inverse_warp", err,
         lambda: knn.knn_inverse_warp(pts_s, verts, skin, tfs, order=order),
         f"B={B} P={pts_s.shape[1]}", b)
    del got_x, got_o, ref_x, ref_o

    # 2: the grad stage's warp, forward and backward
    b = plain_frames(pts_g.shape[1])
    shape = f"B={B} P={pts_g.shape[1]}"
    pts_r = pts_g.clone().requires_grad_(True)
    tfs_r = tfs.clone().requires_grad_(True)
    g = torch.randn(pts_g.shape, generator=rng, device=dev)
    got_x, got_o = knn.knn_inverse_warp_diff(pts_r, verts, skin, tfs_r, order=order)
    got_dp, got_dt = torch.autograd.grad(got_x, (pts_r, tfs_r), g)
    pts_p = pts_g[:b].clone().requires_grad_(True)
    tfs_p = tfs[:b].clone().requires_grad_(True)
    ref_x, ref_o = knn.inverse_warp_plain(pts_p, verts[:b], skin[:b], tfs_p)
    ref_dp, ref_dt = torch.autograd.grad(ref_x, (pts_p, tfs_p), g[:b])
    err_f = check_close("knn_inverse_warp_diff x_c", got_x[:b], ref_x, 1e-5, 1e-5)
    if not torch.equal(got_o[:b], ref_o):
        raise AssertionError("knn_inverse_warp_diff: outlier mask differs")
    err_p = check_close("knn_inverse_warp_diff d/dpts", got_dp[:b], ref_dp, 1e-5, 1e-5)
    # the per-frame transform gradient sums the frame's points in another
    # order than the plain version's autograd
    err_t = check_close("knn_inverse_warp_diff d/dtfs", got_dt[:b], ref_dt, 2e-5, 1e-5)

    def warp_fwd():
        return knn._warp_fwd_cuda(pts_g, verts, skin, tfs, 15, 0.1, True,
                                  "knn_inverse_warp_diff.fwd", order)

    note("knn_inverse_warp_diff.fwd", err_f, warp_fwd, shape, b)
    _, _, inv, wb = warp_fwd()
    xc = got_x.detach().contiguous()
    note("knn_inverse_warp_diff.bwd", max(err_p, err_t),
         lambda: knn._warp_bwd_cuda(g, inv, xc, wb), shape, b)
    del got_dp, got_dt, ref_x, ref_dp, ref_dt, inv, wb, pts_r, pts_p

    # 3: J^-1 at the canonical points, forward and backward
    tfs_p = tfs[:b].clone().requires_grad_(True)
    gj = torch.randn(xc.shape[:2] + (9,), generator=rng, device=dev)
    got_j = knn.knn_jacobian_inverse(xc, verts_c, skin, tfs_r, order=order)
    (got_jt,) = torch.autograd.grad(got_j, tfs_r, gj)
    ref_j = knn.jacobian_inverse_plain(xc[:b], verts_c[:b], skin[:b], tfs_p)
    (ref_jt,) = torch.autograd.grad(ref_j, tfs_p, gj[:b])
    err_f = check_close("knn_jacobian_inverse J^-1", got_j[:b], ref_j, 1e-5, 1e-5)
    err_t = check_close("knn_jacobian_inverse d/dtfs", got_jt[:b], ref_jt, 2e-5, 1e-5)
    note("knn_jacobian_inverse.fwd", err_f,
         lambda: knn._jinv_fwd_cuda(xc, verts_c, skin, tfs, 15, order), shape, b)
    inv_j, wb_j = knn._jinv_fwd_cuda(xc, verts_c, skin, tfs, 15, order)
    note("knn_jacobian_inverse.bwd", err_t, lambda: knn._jinv_bwd_cuda(gj, inv_j, wb_j), shape, b)
    del got_j, got_jt, ref_j, ref_jt, inv_j, wb_j

    # 4: min vertex distance, the object's far-padded buffer with the hand's
    # vertices x 2 in its first rows, at the hand's canonical points; the
    # plain version chunks its points, so it runs on all of them
    cano = xc.reshape(-1, 3)
    bound_v = empty_object_mesh_state(dev)["bound_centers"].clone()
    bound_v[:server.verts_c.shape[1]] = server.verts_c[0] * 2.0
    got = point_mesh.min_vertex_dist_fast(cano, bound_v)
    ref = point_mesh.min_vertex_dist(cano, bound_v)
    err = check_close(f"min_vertex_dist object (P={cano.shape[0]} V={bound_v.shape[0]})", got,
                      ref, 1e-5, 1e-4)
    print(f"    bit for bit equal to the plain version: {bool(torch.equal(got, ref))}",
          flush=True)
    note("min_vertex_dist", err, lambda: point_mesh.min_vertex_dist_fast(cano, bound_v),
         f"P={cano.shape[0]} V={bound_v.shape[0]}", B)
    del got, ref

    # 5, 6: the fused sampler query at 128 samples a ray
    b = plain_frames(P * S)
    shape = f"B={B} P={P} S={S}"
    packs, windows = {}, {}
    for nid in ("right", "object"):
        plans = scene.plans[nid]
        with torch.no_grad():
            packs[nid] = fq.pack_trunk_weights(resolve_weight_norm(params[nid]["implicit"]),
                                               plans.implicit)
        windows[nid] = fq.embed_window(plans.implicit, sum(plans.barf_cfg) // 2,
                                       plans.barf_cfg, dev)
    tf12 = torch.cat([inverse_mat3(obj_tfs[:, :3, :3]).reshape(B, 9), obj_tfs[:, :3, 3]],
                     dim=-1).contiguous()
    hand = (verts, skin, tfs, windows["right"], packs["right"])
    obj = (tf12, windows["object"], packs["object"])
    for name, kern, plain in (
        ("fused_hand_sampler_sdf_z",
         lambda: fq.fused_hand_sampler_sdf_z(*rays, *hand, order=order),
         lambda: fq.hand_query_plain(pts_s[:b], verts[:b], skin[:b], tfs[:b], *hand[3:])),
        ("fused_object_sampler_sdf_z", lambda: fq.fused_object_sampler_sdf_z(*rays, *obj),
         lambda: fq.object_query_plain(pts_s[:b], tf12[:b], *obj[1:])),
    ):
        got = kern()
        ref = plain()
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{name} {shape}: non-finite values")
        err = check_bf16_query(f"{name} {shape}", got[:b].reshape(-1), ref.reshape(-1))
        note(name, err, kern, shape, b)
        del got, ref


def render_batch(torch, seq, dev, n_rays):
    """``n_rays`` pixels of frame 0 at RENDER_DOWNSAMPLE, as one chunk of the
    renderer: those that the ground-truth mask marks as hand or object
    (evenly spaced when there are more), then background pixels evenly
    spaced to fill, in the frame's order.  Returns (batch, pixel indices)."""
    import numpy as np

    from hold_tpu_torch.train import batch_to_device

    fb = seq.full_frame_batch(0, downsample=RENDER_DOWNSAMPLE)

    def spaced(ix, n):
        return ix[np.linspace(0, len(ix) - 1, n).round().astype(int)] if n < len(ix) else ix

    fg = spaced(np.flatnonzero(fb["gt_mask"] > 0), n_rays)
    pix = np.sort(np.concatenate([fg, spaced(np.flatnonzero(fb["gt_mask"] == 0),
                                             n_rays - len(fg))]))
    batch = batch_to_device({k: fb[k] for k in ("frame_idx", "intrinsics", "extrinsics",
                                                  "scene_scale")}, dev)
    batch["uv"] = torch.as_tensor(np.asarray(fb["uv"])[:, pix], device=dev)
    return batch, pix


def render_checks(torch, seq, scene, params, dev, record) -> None:
    """Phase 3, rows 8 and 9: the fused render kernels against their plain
    versions at one render chunk's real points."""
    from hold_tpu_torch.models.holdnet import _rays, sample_all_z
    from hold_tpu_torch.models.mlp import _apply_linear, resolve_weight_norm
    from hold_tpu_torch.models.nodes import _mano_pose, _object_pose, node_render_packs
    from hold_tpu_torch.ops import fused_query as fq
    from hold_tpu_torch.ops import fused_render as fr
    from hold_tpu_torch.utils.transforms import inverse_mat3

    batch, _ = render_batch(torch, seq, dev, PIXEL_PER_BATCH)
    ray_dirs, cam_loc = _rays(batch)
    z = sample_all_z(params, scene, batch, None, None, None)
    B = 1
    inputs = {}
    with torch.no_grad():
        for nid in ("right", "object"):
            rend = resolve_weight_norm(params[nid]["rendering"])
            pts = (cam_loc[:, None] + z[nid][..., None] * ray_dirs[:, None]).reshape(1, -1, 3)
            packs = node_render_packs(params[nid], scene.plans[nid], dev)
            if nid == "right":
                srv = scene.servers[nid]
                out, cond = _mano_pose(params[nid], srv, batch, None)
                frame = (out.verts.contiguous(), srv.verts_c.expand(B, -1, -1).contiguous(),
                         srv.skin_weights_c.expand(B, -1, -1).contiguous(), out.tfs.contiguous())
                fb0 = fr.frame_bias0(rend, _apply_linear(rend["lin_pose"], cond))
            else:
                tfs = _object_pose(params[nid], scene.servers[nid], batch).obj_tfs
                frame = (torch.cat([inverse_mat3(tfs[:, :3, :3]).reshape(B, 9), tfs[:, :3, 3]],
                                   -1).contiguous(),)
                tc = params[nid]["frame_latent"][batch["frame_idx"]]
                fb0 = fr.frame_bias0(rend, torch.zeros((B, 8), device=dev), tc)
            inputs[nid] = (pts.contiguous(), *frame, *packs, fb0.detach())
    V, J = inputs["right"][1].shape[1], inputs["right"][3].shape[2]
    order = scene.plans["right"].tile_order
    hand_search = hand_render_search(torch, inputs["right"], order)
    wbytes = ((fq.W_TOTAL + fr.T_TOTAL + fr.C_TOTAL) * 2.0
              + (fq.F_TOTAL + fr.CB_TOTAL + 256) * 4.0)
    act = 8 * 256 * 10.0 + 8 * 256 + 4 * 256 * 2 + 60  # activations, sigmoids, relus
    for name, nid, kern, plain, f32_pp, bytes_once in (
        ("fused_hand_render", "right", lambda *a: fr.fused_hand_render(*a, order=order),
         fr.hand_render_plain, act + 2 * knn_needed(1, V, J) + 42 * J + 75,
         wbytes + frame_bytes(B, V, J) + B * V * 12),
        ("fused_object_render", "object", fr.fused_object_render, fr.object_render_plain,
         act + 24, wbytes + 48),
    ):
        args = inputs[nid]
        n = args[0].shape[1]
        # the chunk, then its first N - 61 points: no multiple of the shade's tile
        ragged = (args[0][:, :n - 61].contiguous(), *args[1:])
        read = {}
        for tag, a in (("", args), (f" N={n - 61}", ragged)):
            got, ref = kern(*a), plain(*a)
            torch.cuda.synchronize()
            for g, r in zip(got, ref):
                if g.shape != r.shape or not bool(torch.isfinite(g).all()):
                    raise AssertionError(f"{name}{tag}: shape {tuple(g.shape)} or non-finite values")
            e = {"sdf": check_bf16_query(f"{name}{tag} sdf", got[0], ref[0]),
                 "x_c": check_close(f"{name}{tag} x_c", got[4], ref[4], 1e-5, 1e-5),
                 "dist": check_close(f"{name}{tag} dist", got[3], ref[3], 0.0, 1e-5),
                 "rgb": check_close(f"{name}{tag} rgb", got[1], ref[1], 0.0, RENDER_RGB)}
            d_n = (got[2] - ref[2]).abs().flatten()
            p99, n_max = float(d_n.quantile(0.99)), float(d_n.max())
            ok = p99 <= RENDER_NRM_P99 and n_max <= RENDER_NRM_MAX
            print(f"  {name}{tag} normal: p99 |d| {p99:.3e} (tol {RENDER_NRM_P99}), max "
                  f"{n_max:.3e} (tol {RENDER_NRM_MAX}) {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                raise AssertionError(f"{name}{tag}: normals disagree with the plain version")
            e["normal"] = n_max
            read[tag] = (e, got, ref, p99)
        worst = max(max(e.values()) for e, *_ in read.values())
        errs, got, ref, p99 = read[""]
        errs["ragged"] = read[f" N={n - 61}"][0]
        ms = cuda_ms(torch, lambda: kern(*args))
        record(name, worst, ms, cuda_ms(torch, lambda: plain(*args), fill_ms=0.0),
               f"B={B} N={n} ({PIXEL_PER_BATCH} rays x {n // PIXEL_PER_BATCH} samples; also "
               f"N={n - 61})",
               bound(2.0 * fr.RENDER_MACS * n, f32_pp * n, 56.0 * n + bytes_once),
               errors=errs, mean_abs_err=float((got[0] - ref[0]).abs().mean()),
               normal_p99=p99, max_abs_sdf=float(ref[0].abs().max()),
               tflop_s=fr.RENDER_FLOPS_PER_POINT * n / (ms * 1e-3) / 1e12,
               split_ms=kernel_split(torch, name, lambda: kern(*args),
                                     ("render_warp_kernel", "render_shade_kernel")),
               **({"search": hand_search} if nid == "right" else {}))


def hand_render_search(torch, args, order) -> dict:
    """Phase 3, row 8's search, at one render chunk's points (``args``: the
    hand render's inputs): the warp's two neighbour searches (the posed
    vertices at the world points, the canonical ones at x_c) through the
    KNN kernels, which share the render warp kernel's search, held to the
    plain version's neighbour sets exactly; the render call's culled share;
    then the render with a block of the hand's vertices duplicated (posed
    and canonical): its x_c and distance against the plain warp step's,
    and lanes must take the tie sweep."""
    from hold_tpu_torch.ops import fused_render as fr
    from hold_tpu_torch.ops import knn

    pts, verts, verts_c, skin, tfs = args[:5]
    out = {}
    def posed():
        return knn._warp_fwd_cuda(pts, verts, skin, tfs, 15, 0.1, True,
                                  "knn_inverse_warp_diff.fwd", order)

    out["posed"] = check_support(torch, "fused_hand_render's search, posed vertices",
                                 lambda: posed()[3], pts, verts, skin)
    xc = posed()[0]
    out["canonical"] = check_support(
        torch, "fused_hand_render's search, canonical vertices at x_c",
        lambda: knn._jinv_fwd_cuda(xc, verts_c, skin, tfs, 15, order)[1], xc, verts_c, skin)
    out["render"] = search_counts(torch, "fused_hand_render",
                                  lambda: fr.fused_hand_render(*args, order=order))
    tie = [t.clone() for t in (verts, verts_c)]
    for t in tie:
        t[:, 300:364] = t[:, 100:164]
    with knn.count_search(torch.device("cuda")) as c:
        got = fr.fused_hand_render(pts, *tie, *args[3:], order=order)
        torch.cuda.synchronize()
    ref_x, _, ref_d = fr.hand_render_warp_plain(pts, *tie, skin, tfs)
    check_close("fused_hand_render x_c, vertices 100-163 duplicated", got[4], ref_x, 1e-5, 1e-5)
    check_close("fused_hand_render dist, vertices 100-163 duplicated", got[3], ref_d, 0.0, 1e-5)
    out["duplicated_tie_lanes"] = int(c[1])
    print(f"    {int(c[1])} of {int(c[0])} lanes took the tie sweep", flush=True)
    if int(c[1]) == 0:
        raise AssertionError("the duplicated vertices sent no lane of the render through the "
                             "tie sweep")
    return out


@contextlib.contextmanager
def recorded_queries(calls: list):
    """While open, every call of the nodes' sampler queries (the fused query
    kernels' wrappers) is appended to ``calls`` as (kind, args, kwargs,
    output), kind "hand" or "object", in the order the sampler made them."""
    from hold_tpu_torch.models import nodes

    kernels = (nodes.fused_hand_sampler_sdf_z, nodes.fused_object_sampler_sdf_z)

    def recorder(kind, fn):
        def call(*a, **k):
            out = fn(*a, **k)
            calls.append((kind, a, k, out))
            return out
        return call

    nodes.fused_hand_sampler_sdf_z, nodes.fused_object_sampler_sdf_z = (
        recorder("hand", kernels[0]), recorder("object", kernels[1]))
    try:
        yield
    finally:
        nodes.fused_hand_sampler_sdf_z, nodes.fused_object_sampler_sdf_z = kernels


def plain_query(torch, call, device):
    """A recorded sampler query's plain version on ``device``, at the
    call's own inputs: sdf (B, P, S)."""
    from hold_tpu_torch.ops import fused_query as fq

    kind, a, k, _ = call

    def to(x):
        if isinstance(x, dict):
            return {n: to(t) for n, t in x.items()}
        return x.to(device) if torch.is_tensor(x) else x

    a = [to(x) for x in a]
    pts = fq.points_from_rays_z(*a[:3])
    if kind == "hand":
        return fq.hand_query_plain(pts, *a[3:8], k.get("K", 15)).reshape(a[2].shape)
    return fq.object_query_plain(pts, *a[3:6]).reshape(a[2].shape)


def sampler_reads_check(torch, calls: list, dev) -> None:
    """Phase 4: the sdf that the card's sampler read, every call of the fused
    query kernels at its own inputs, against the plain versions on the CPU
    at the same inputs, under the fused query's bounds (FQ_MAX, FQ_MEAN);
    beside it, as a witness that the card and the CPU compute the same
    function there, the plain versions on the card against the CPU's.  The
    z tables themselves are not held to a bound: the rest of the sampler
    (plain PyTorch on both devices) rounds differently on each, and its
    inverse-CDF draws turn a small difference into a jump of a whole sample
    spacing (``agreement_check`` prints how many move)."""
    cpu = torch.device("cpu")
    for kind in ("hand", "object"):
        mine = [c for c in calls if c[0] == kind]
        got = torch.cat([c[3].reshape(-1) for c in mine]).cpu()
        ref = torch.cat([plain_query(torch, c, cpu).reshape(-1) for c in mine])
        card = torch.cat([plain_query(torch, c, dev).reshape(-1) for c in mine]).cpu()
        what = f"{kind} sdf the sampler read ({len(mine)} calls, {got.numel()} samples)"
        check_bf16_query(f"{what}, card kernels vs CPU plain", got, ref)
        check_bf16_query(f"{what}, card plain vs CPU plain", card, ref)


def z_moved_share(torch, got, ref) -> tuple:
    """(the share of the samples of z tables ``got`` that lie farther than
    0.1 x the median sample spacing from ``ref``'s, the rays holding them,
    the rays)."""
    d = (got.cpu() - ref.cpu()).abs()
    beyond = d > 0.1 * float(torch.diff(ref.cpu(), dim=1).median())
    return float(beyond.float().mean()), int(beyond.any(dim=1).sum()), d.shape[0]


def z_moved(torch, got, ref) -> str:
    share, rays, n = z_moved_share(torch, got, ref)
    return f"{share:.5f} ({rays} of {n} rays)"


@contextlib.contextmanager
def float32_exponentials(torch):
    """The error-bound sampler's exponentials in float32, as before their
    float64 repair (phase 4's control): its plain steps on every device
    (the card's kernels have no float32 form)."""
    from hold_tpu_torch.render import ray_sampler

    real = (ray_sampler._exp64, ray_sampler.error_bound_round, ray_sampler.error_bound_final)
    ray_sampler._exp64 = torch.exp
    ray_sampler.error_bound_round = ray_sampler.error_bound_round_plain
    ray_sampler.error_bound_final = ray_sampler.error_bound_final_plain
    try:
        yield
    finally:
        ray_sampler._exp64, ray_sampler.error_bound_round, ray_sampler.error_bound_final = real


def agreement_check(torch, seq, args, cfg, dev, fused_train: bool, pairs: int = 1,
                    rays: int = 16, z_case: str = "one hand", shade_f32: bool = True) -> None:
    """Phase 4: grad-stage loss and gradients, card kernels vs CPU plain path,
    on ``pairs`` pairs of frames x ``rays`` rays, with the fused training
    shade or the chunked one (``--no_fused_train``).
    The chunked path is held to 1e-4 (losses) and 2e-4 (gradients); the
    fused one, whose bf16 roundings fall on different sides where the sums'
    order differs, to 2e-3 (losses, the JAX package's fused-vs-chunked bound)
    and each parameter's gradient to AGREE_LIMIT, beside two more CPU runs
    read the same way: the plain path with float64 products (sound) and the
    chunked f32 shade (the control).  Every run shades the card's z tables;
    the sdf that the card's sampler read to place them is held to the CPU's
    at the same inputs (``sampler_reads_check``).  The chunked shade runs in
    float32 (``shade_f32``, as these readings were taken) but for the bf16
    check (``fused_train=False, shade_f32=False``): the card's bf16 chunked
    shade against the same shade on the CPU, losses at 2e-3, each
    parameter's gradient under BF16_AGREE_LIMIT with the CPU's float32
    chunked shade as the control that must fail it."""
    import numpy as np

    from hold_tpu_torch.models.holdnet import (
        build_scene, empty_object_mesh_state, holdnet_forward, init_scene_params,
        sample_all_z, sample_step_draws,
    )
    from hold_tpu_torch.models.losses import compute_losses
    from hold_tpu_torch.train import batch_to_device
    from hold_tpu_torch.utils.convert import flatten_params, leaf_params

    step, epoch = 300, 25  # hand loss targets active, pose conditioning on
    opt_model = dict(cfg["model"])
    batch_np = seq.sample_tempo_batch(np.random.RandomState(1), pairs, 1, rays)
    params0 = init_scene_params(torch.Generator().manual_seed(3),
                                build_scene(opt_model, dict(args), seq.scene_data(), "cpu"),
                                seq.scene_data())
    scene_cpu = build_scene(opt_model, dict(args), seq.scene_data(), "cpu")
    draws_cpu = sample_step_draws(scene_cpu, 2 * pairs, rays, torch.Generator().manual_seed(4))
    z_card = {}

    def grad_stage(device, fused: bool = fused_train, f32: bool = shade_f32):
        scene = build_scene(opt_model, dict(args), seq.scene_data(), device, fused_train=fused,
                            shade_f32=f32)
        if not fused and [scene.plans[nid].shade_bf16 for nid in scene.node_ids] != [not f32] * len(
                scene.node_ids):
            raise AssertionError(f"the chunked shade is not {'f32' if f32 else 'bf16'}")
        if [scene.plans[nid].fused_train for nid in scene.node_ids] != [fused] * len(
                scene.node_ids):
            raise AssertionError(f"fused training shade not {fused} on every node")
        params = leaf_params(params0, device)
        batch = batch_to_device(batch_np, device)
        if not z_card:  # the card's sampler places the samples for every run
            if not all(scene.plans[nid].fused_query for nid in scene.node_ids):
                raise AssertionError("the slice's sampler is not the fused one")
            calls = []
            with recorded_queries(calls):
                z_card.update(sample_all_z(params, scene, batch, None, step, epoch))
            sampler_reads_check(torch, calls, dev)
        z = {k: v.to(device) for k, v in z_card.items()}
        draws = {k: (tuple(t.to(device) for t in v) if isinstance(v, tuple) else v.to(device))
                 for k, v in draws_cpu.items()}
        out = holdnet_forward(params, scene, batch, empty_object_mesh_state(device), draws,
                              step, epoch, z_vals_dict=z)
        loss = compute_losses(batch, out, scene.node_ids, step)
        flat = flatten_params(params)
        names = [k for k, t in flat.items() if t.requires_grad]
        g = torch.autograd.grad(loss["loss"], [flat[k] for k in names], allow_unused=True)
        return ({k: float(v.detach()) for k, v in loss.items()},
                {k: (torch.zeros_like(flat[k]) if gi is None else gi).cpu()
                 for k, gi in zip(names, g)})

    losses, grads = {}, {}
    losses["cuda"], grads["cuda"] = grad_stage(dev)
    losses["cpu"], grads["cpu"] = grad_stage(torch.device("cpu"))
    rtol = 2e-3 if fused_train or not shade_f32 else 1e-4
    for k, v in losses["cpu"].items():
        got = losses["cuda"][k]
        print(f"  {k}: card {got:.6f} cpu {v:.6f}", flush=True)
        if not (math.isfinite(got) and abs(got - v) <= rtol * abs(v) + 1e-5):
            raise AssertionError(f"{k}: card and CPU disagree")
    if fused_train:
        # how far the z tables themselves move: the card's against the CPU's,
        # held to the limit of ``z_case`` (z_moved_limit); the same with the
        # sampler's exponentials in float32 on both (the control, which must
        # exceed it); and, report only, on the CPU alone with the products
        # summed in float64 against without
        cpu = torch.device("cpu")
        p_cpu, b_cpu = leaf_params(params0, cpu), batch_to_device(batch_np, cpu)
        z_cpu = sample_all_z(p_cpu, scene_cpu, b_cpu, None, step, epoch)
        with products_in_f64(torch):
            z_f64 = sample_all_z(p_cpu, scene_cpu, b_cpu, None, step, epoch)
        scene_dev = build_scene(opt_model, dict(args), seq.scene_data(), dev)
        with float32_exponentials(torch):
            z32_card = sample_all_z(leaf_params(params0, dev), scene_dev,
                                    batch_to_device(batch_np, dev), None, step, epoch)
            z32_cpu = sample_all_z(p_cpu, scene_cpu, b_cpu, None, step, epoch)
        worst, worst32 = 0.0, 0.0
        limit = z_moved_limit(z_case, z_cpu["object"].numel())
        for nid in scene_cpu.node_ids:
            share = z_moved_share(torch, z_card[nid], z_cpu[nid])
            share32 = z_moved_share(torch, z32_card[nid], z32_cpu[nid])
            worst, worst32 = max(worst, share[0]), max(worst32, share32[0])
            print(f"  z table {nid}, samples moved beyond 0.1 x the median spacing: card vs "
                  f"CPU {share[0]:.5f} ({share[1]} of {share[2]} rays), with float32 "
                  f"exponentials {share32[0]:.5f} ({share32[1]} of {share32[2]} rays); CPU with "
                  f"float64 products vs CPU {z_moved(torch, z_f64[nid], z_cpu[nid])} (report "
                  f"only)", flush=True)
        print(f"  z tables ({z_case}): worst share card vs CPU {worst:.5f} (limit {limit:.5f}) "
              f"{'ok' if worst <= limit else 'FAIL'}; the float32 control's "
              f"{worst32:.5f} {'fails it: ok' if worst32 > limit else 'passes: FAIL'}",
              flush=True)
        if worst > limit or worst32 <= limit:
            raise AssertionError("z tables: card and CPU apart, or the float32 control within")
        with products_in_f64(torch):
            _, grads["f64 products"] = grad_stage(torch.device("cpu"))
        _, grads["chunked"] = grad_stage(torch.device("cpu"), fused=False, f32=True)
        read = {lab: {k: grad_reading(torch, grads[src][k], ref) for k, ref in grads["cpu"].items()}
                for lab, src in (("kernel", "cuda"), ("f64 products", "f64 products"),
                                 ("chunked", "chunked"))}
        print(f"  {len(read['kernel'])} gradient tensors, worst |d| / bound (share beyond) against "
              f"the CPU's, of the card | f64 products | chunked:", flush=True)
        for lab, r in read.items():
            w = max(r.values())
            print(f"    {lab}: {sum(v[0] <= 1.0 for v in r.values())} tensors wholly within the "
                  f"bound, worst {w[0]:.3f} (share {w[1]:.2e}), largest share "
                  f"{max(v[1] for v in r.values()):.2e}", flush=True)
        show = sorted(read["kernel"], key=lambda k: -max(read["kernel"][k][0],
                                                         read["f64 products"][k][0]))[:12]
        print("    the 12 worst, and every tensor that either fails:", flush=True)
        failed, caught = grad_table(read, {k: AGREE_LIMIT for k in read["kernel"]}, show,
                                    "chunked")
        print(f"  the chunked control fails {len(caught)} of {len(read['kernel'])} tensors "
              f"{'ok' if caught else 'FAIL'}", flush=True)
        if failed or not caught:
            raise AssertionError(f"gradients beyond their limit: {failed[:8]}, or the limit "
                                 f"passes the chunked control")
        return
    if not shade_f32:
        _, grads["f32 chunked"] = grad_stage(torch.device("cpu"), f32=True)
        read = {lab: {k: grad_reading(torch, grads[src][k], ref) for k, ref in grads["cpu"].items()}
                for lab, src in (("kernel", "cuda"), ("f32 chunked", "f32 chunked"))}
        print(f"  {len(read['kernel'])} gradient tensors, worst |d| / bound (share beyond) against "
              f"the CPU's bf16 chunked shade, of the card | the CPU's f32 chunked shade:",
              flush=True)
        for lab, r in read.items():
            w = max(r.values())
            print(f"    {lab}: {sum(v[0] <= 1.0 for v in r.values())} tensors wholly within the "
                  f"bound, worst {w[0]:.3f} (share {w[1]:.2e}), largest share "
                  f"{max(v[1] for v in r.values()):.2e}", flush=True)
        show = sorted(read["kernel"], key=lambda k: -read["kernel"][k][0])[:12]
        print("    the 12 worst, and every tensor that either fails:", flush=True)
        failed, caught = grad_table(read, {k: BF16_AGREE_LIMIT for k in read["kernel"]}, show,
                                    "f32 chunked")
        print(f"  the f32 control fails {len(caught)} of {len(read['kernel'])} tensors "
              f"{'ok' if caught else 'FAIL'}", flush=True)
        if failed or not caught:
            raise AssertionError(f"bf16 chunked gradients beyond their limit: {failed[:8]}, or "
                                 f"the limit passes the f32 control")
        return
    bad = []
    for k, ref in grads["cpu"].items():
        scale = float(ref.abs().max())
        if max_err(grads["cuda"][k], ref) > 2e-4 * scale + 2e-4:
            bad.append(k)
    print(f"  {len(grads['cpu'])} gradient tensors, tolerance 2e-4*max|ref| + 2e-4: "
          f"{len(bad)} outside", flush=True)
    if bad:
        raise AssertionError(f"gradients disagree: {bad[:8]}")


def render_agreement(torch, seq, args, cfg, dev) -> None:
    """Phase 4, render: one chunk of 256 hand and object rays, the card's
    eval z tables given to both sides, holdnet_render with the fused render
    kernels on the card against their plain versions on the CPU, on the
    composited maps.  The rays' mean mask_prob must reach MASK_FLOOR, so
    that the maps compared carry the nodes' shade."""
    from hold_tpu_torch.models.holdnet import (
        build_scene, holdnet_render, init_scene_params, sample_all_z,
    )
    from hold_tpu_torch.utils.convert import leaf_params

    params0 = init_scene_params(torch.Generator().manual_seed(3),
                                build_scene(dict(cfg["model"]), dict(args), seq.scene_data(), "cpu"),
                                seq.scene_data())
    maps, z_vals = {}, None
    for device in (dev, torch.device("cpu")):
        scene = build_scene(dict(cfg["model"]), dict(args), seq.scene_data(), device)
        if not all(p.fused_render for p in scene.plans.values()):
            raise AssertionError("the slice's render shade is not the fused one")
        params = leaf_params(params0, device)
        batch, _ = render_batch(torch, seq, device, 256)
        if z_vals is None:
            z_vals = sample_all_z(params, scene, batch, None, None, None)
        out = holdnet_render(params, scene, batch, {k: v.to(device) for k, v in z_vals.items()})
        maps[device.type] = {k: out[k].cpu() for k in RENDER_MAP_TOL}
    mask = float(maps["cuda"]["mask_prob"].mean())
    print(f"  render rays: mean mask_prob {mask:.4f} (floor {MASK_FLOOR}) "
          f"{'ok' if mask >= MASK_FLOOR else 'FAIL'}", flush=True)
    if mask < MASK_FLOOR:
        raise AssertionError("the compared render rays miss the hand and the object")
    for k, tol in RENDER_MAP_TOL.items():
        d = max_err(maps["cuda"][k], maps["cpu"][k])
        print(f"  render {k}: max |card - cpu| {d:.3e} (tol {tol:g}) "
              f"{'ok' if d <= tol else 'FAIL'}", flush=True)
        if not (d <= tol and bool(torch.isfinite(maps["cuda"][k]).all())):
            raise AssertionError(f"render {k}: card and CPU disagree")


def slice_run(torch, seq, args, cfg, dev, steps: int, path: str | None = None,
              first: int = 0) -> tuple:
    """Phase 5, one run: ``run_training`` from counters at 0, steps ``first``
    to ``first + steps`` (a run that resumes at ``first``); checks the
    losses and that this path launched each of its kernels and none off it.
    Returns the launch counts and what run_training returned."""
    from hold_tpu_torch.ops import fused_query, fused_render, fused_shade, knn, point_mesh
    from hold_tpu_torch.train import run_training

    path = path or ("layer" if args.get("no_fused_sampler") else
                    "chunked" if args.get("no_fused_train") else "fused")
    flags = [f for f in ("no_remat", "shade_f32") if args.get(f)]
    print(f"  -- {path}{''.join(f' (--{f})' for f in flags)}: {steps} steps", flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mods = (knn, point_mesh, fused_query, fused_render, fused_shade)
    for mod in mods:
        mod.reset_launch_counts()
    params, scene, mesh_state, tracker, timer, _ = run_training(args, cfg, seq=seq,
                                                                max_steps=first + steps,
                                                                device=dev)
    torch.cuda.synchronize()
    launches = {k: v for mod in mods for k, v in mod.LAUNCHES.items()}
    peak = torch.cuda.max_memory_allocated()
    fused = [nid for nid in scene.node_ids if scene.plans[nid].fused_query]
    shade = [nid for nid in scene.node_ids if scene.plans[nid].fused_train]
    if (fused != (list(scene.node_ids) if path != "layer" else [])
            or shade != (list(scene.node_ids) if path != "chunked" else [])):
        raise AssertionError(f"{path} run: fused sampler on {fused}, fused shade on {shade}")
    if path == "chunked":
        bf16 = [scene.plans[nid].shade_bf16 for nid in scene.node_ids]
        if bf16 != [not args.get("shade_f32")] * len(bf16):
            raise AssertionError(f"chunked run: bf16 products {bf16} with --shade_f32 "
                                 f"{bool(args.get('shade_f32'))}")
        print(f"  the chunked shade's products: {'float32' if args.get('shade_f32') else 'bf16'}",
              flush=True)
    with open(os.path.join(tracker.log_dir, "metrics.jsonl")) as f:
        records = [r for r in map(json.loads, f) if "loss" in r and r["step"] >= first]
    if len(records) != steps:
        raise AssertionError(f"expected {steps} metric records, got {len(records)}")
    for rec in records:
        bad = {k: v for k, v in rec.items() if k.startswith("loss") and not math.isfinite(v)}
        if bad:
            raise AssertionError(f"non-finite losses at step {rec['step']}: {bad}")
        print(f"  step {rec['step']}: loss {rec['loss']:.5f} rgb {rec['loss/rgb']:.5f} "
              f"psnr {rec['psnr']:.3f}")
    print(f"  launches: {launches}")
    bad = path_check(path, launches)
    if bad:
        raise AssertionError(bad[0])
    summ = timer.summary()
    rays = BATCH_SIZE * 2 * int(args["num_sample"])
    step_s = summ["sampler"] + summ["grad"] + summ["data"]
    print(f"  sampler_ms {summ['sampler'] * 1e3:.3f}")
    print(f"  grad_ms {summ['grad'] * 1e3:.3f}")
    print(f"  data_ms {summ['data'] * 1e3:.3f}")
    print(f"  rays_per_s {rays / step_s:.1f} ({rays} rays per step, steps {first + 1}.."
          f"{first + steps - 1})")
    for ph in ("checkpoint", "val_render"):  # outside the step walls
        if ph in timer.totals:
            print(f"  {ph}_ms {summ[ph] * 1e3:.3f} (mean of {timer.counts[ph]})")
    print(f"  max_memory_allocated_bytes {peak} ({peak / 2**30:.3f} GiB)", flush=True)
    train_profile(torch, seq, args, scene, params, mesh_state, dev, summ)
    return launches, (params, scene, mesh_state, tracker)


def path_check(path: str, launches: dict) -> list:
    """[] when run ``path`` launched each kernel of its path (KERNELS) and
    none off it, else [what is wrong]."""
    missing = [k for k, (_, _, paths) in KERNELS.items() if path in paths and launches[k] == 0]
    stray = [k for k, (_, _, paths) in KERNELS.items() if path not in paths and launches[k]]
    if missing or stray:
        return [f"{path} run: not launched {missing}, launched off its path {stray}"]
    return []


def loop_outputs(log_dir: str, at_step: int, val: bool) -> None:
    """Phase 5: what a run leaves at ``at_step``: ``step_<at_step>.pt`` with
    ``last.pt`` pointing at it (its size printed) and, with ``val``, a
    validation panel of that step and a finite ``val/psnr``.  A validation
    that failed is only logged by the loop, as in the reference, so it is
    checked here."""
    import glob

    root = os.path.join(log_dir, "checkpoints")
    ckpt = os.path.join(root, f"step_{at_step:09d}.pt")
    if not os.path.isfile(ckpt) or os.path.realpath(os.path.join(root, "last.pt")) != ckpt:
        raise AssertionError(f"no {ckpt}, or last.pt does not point at it")
    print(f"  checkpoint {os.path.basename(ckpt)} <- last.pt: {os.path.getsize(ckpt)} bytes",
          flush=True)
    if not val:
        return
    pngs = glob.glob(os.path.join(log_dir, "visuals", f"val_*_{at_step:09d}.png"))
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        psnr = [r["val/psnr"] for r in map(json.loads, f)
                if "val/psnr" in r and r["step"] == at_step]
    print(f"  validation at step {at_step}: {[os.path.basename(p) for p in pngs]}, val/psnr "
          f"{psnr}", flush=True)
    if not pngs or len(psnr) != 1 or not math.isfinite(psnr[0]):
        raise AssertionError(f"no validation panel or no finite val/psnr at step {at_step}")


def resume_checks(torch, seq, args, cfg, dev) -> dict:
    """Phase 5: ``run_training`` again on the fused run's experiment.  At the
    saved step (no step to run) its parameters and Adam state must equal the
    checkpoint's bit for bit; then 2 steps from there (the "resume" path),
    which must write their checkpoint and validation.  Returns the 2 steps'
    launch counts."""
    from hold_tpu_torch.train import run_training
    from hold_tpu_torch.utils.checkpoint import read_checkpoint
    from hold_tpu_torch.utils.convert import flatten_params

    log_dir = os.path.join(args["log_root"], args["exp_key"])
    saved = read_checkpoint(os.path.join(log_dir, "checkpoints", "last.pt"))
    params, _, _, _, timer, opt = run_training(args, cfg, seq=seq, max_steps=STEPS, device=dev)
    flat = flatten_params(params)
    bad = [k for k, t in flat.items() if not torch.equal(t.detach().cpu(), saved["params"][k])]
    got, ref = opt.state_dict(), saved["optimizer"]
    adam = [(i, name, t) for i, st in ref["state"].items() for name, t in st.items()]
    bad += [f"adam {i}.{name}" for i, name, t in adam
            if not torch.equal(got["state"][i][name].cpu(), t.cpu())]
    if got["param_groups"] != ref["param_groups"]:
        bad.append("adam param_groups")
    print(f"  resumed at step {saved['step']}: {len(flat)} parameter tensors and {len(adam)} "
          f"Adam state tensors against the checkpoint's, {len(bad)} differ", flush=True)
    if saved["step"] != STEPS or timer.counts or bad:
        raise AssertionError(f"resume: step {saved['step']}, steps run {timer.counts}, "
                             f"differ {bad[:8]}")
    del params, opt
    launches, _ = slice_run(torch, seq, args, cfg, dev, 2, path="resume", first=STEPS)
    loop_outputs(log_dir, STEPS + 2, val=True)
    return launches


def fast_run(torch, seq, data_root: str, dev) -> dict:
    """Phase 5: ``-f`` through the CLI's parser at full width: 8 rays a frame,
    the sampler at 16 / 32 / 8 samples and 2 rounds, 2 steps (the "fast"
    path).  Returns the launch counts."""
    args, cfg = fast_config(data_root)
    launches, run = slice_run(torch, seq, args, cfg, dev, 2, path="fast")
    sc = run[1].sampler_cfg
    print(f"  -f: {args['num_sample']} rays a frame, samples {sc.N_samples} / "
          f"{sc.N_samples_eval} / {sc.N_samples_extra}, {sc.max_total_iters} rounds", flush=True)
    if (sc.N_samples, sc.N_samples_eval, sc.N_samples_extra, sc.max_total_iters) != (16, 32, 8, 2):
        raise AssertionError("-f did not shorten the sampler")
    loop_outputs(run[3].log_dir, 2, val=False)
    return launches


def two_hand_run(torch, args, cfg, dev, launches: dict) -> dict:
    """Phase 5: a two-hand synthetic sequence (12 frames, 240x320): phase
    4's fused agreement at 16 rays, then 3 steps with the defaults at 1280
    rays (the "two_hands" path).  Each hand must run its own rows 2, 3 and
    5 (twice the launches of the one-hand chunked run, whose steps are as
    many) and row 7 must shade three nodes (1.5 times the one-hand layer
    run's).  Returns the launch counts."""
    from hold_tpu_torch.data.dataset import SequenceData
    from hold_tpu_torch.data.synthetic import generate_sequence
    from hold_tpu_torch.utils.config import Cfg

    built = generate_sequence(None, FRAMES, IMG_HW, two_hands=True)
    seq = SequenceData(built["images"], built["masks"], built["data"], num_sample=RAYS_PER_FRAME)
    print(f"  -- two hands: the fused agreement at 16 rays ({seq.hand_ids} + object)",
          flush=True)
    agreement_check(torch, seq, args, cfg, dev, fused_train=True, z_case="two hands")
    got, run = slice_run(torch, seq, Cfg({**args, "exp_key": "chip_smoke_two_hands"}), cfg, dev,
                         LAYER_STEPS, path="two_hands")
    if run[1].node_ids != ("right", "left", "object"):
        raise AssertionError(f"two-hand scene has nodes {run[1].node_ids}")
    want = {k: 2 * launches["chunked"][k] for k in (
        "knn_inverse_warp_diff.fwd", "knn_inverse_warp_diff.bwd", "knn_jacobian_inverse.fwd",
        "knn_jacobian_inverse.bwd", "fused_hand_sampler_sdf_z")}
    want.update({k: 3 * launches["layer"][k] // 2 for k in ("fused_shade_train.fwd",
                                                            "fused_shade_train.bwd")})
    print(f"  launches for both hands (two-hand run / expected): "
          f"{ {k: (got[k], v) for k, v in want.items()} }", flush=True)
    if any(got[k] != v for k, v in want.items()):
        raise AssertionError("the two-hand run did not launch rows 2, 3, 5 and 7 for both hands")
    return got


@contextlib.contextmanager
def timed_sdf_queries():
    """While open, the SDF queries of canonical meshing are timed: yields
    [seconds, calls, points], the host clock around each batch of queries
    (they end in a copy to the host, so the device's work is in it)."""
    from hold_tpu_torch.meshing import cano

    spent = [0.0, 0, 0]
    make = cano.make_node_sdf_fn

    def timed_make(*a, **k):
        fn = make(*a, **k)

        def timed(pts):
            t0 = time.perf_counter()
            out = fn(pts)
            spent[0] += time.perf_counter() - t0
            spent[1] += 1
            spent[2] += pts.shape[0]
            return out

        return timed

    cano.make_node_sdf_fn = timed_make
    try:
        yield spent
    finally:
        cano.make_node_sdf_fn = make


def meshing_checks(torch, seq, args, dev, fused) -> None:
    """Phase 5, after the fused run: the run's own meshing (at epoch 3) must
    have written the object's mesh and left a valid object state.  Then its
    parameters (after its profiled steps) are meshed again at the
    reference's resolutions (hand 64, object 32 with res_up 2), timed: wall,
    the SDF queries on the device, MISE on the host (the rest).  The
    object's state from that mesh must be
    valid and give non-zero object sparse and eikonal terms on a batch,
    where the empty state gives zero; 3 training steps with it and 3 with
    the empty state must have finite losses, and their grad_ms are printed
    side by side."""
    import glob

    import numpy as np

    from hold_tpu_torch.meshing.cano import mesh_hand_cano, mesh_object_cano
    from hold_tpu_torch.models.holdnet import (
        empty_object_mesh_state, holdnet_forward, object_mesh_state_from_mesh, sample_all_z,
        sample_step_draws,
    )
    from hold_tpu_torch.models.losses import eikonal_loss, opacity_sparse_loss
    from hold_tpu_torch.train import (
        batch_to_device, make_train_step, meshing_snapshot, optimizer_for,
    )
    from hold_tpu_torch.utils.tracing import StepTimer

    params, scene, run_state, tracker = fused
    written = sorted(glob.glob(os.path.join(tracker.log_dir, "mesh_cano", "mesh_cano_*.obj")))
    misc = sorted(glob.glob(os.path.join(tracker.log_dir, "misc", "*.npy")))
    print(f"  the fused run's meshing: {[os.path.basename(p) for p in written]}, misc "
          f"{[os.path.basename(p) for p in misc]}; its object state valid "
          f"{float(run_state['valid']):.0f}", flush=True)
    if not any("_object_" in p for p in written) or not misc or float(run_state["valid"]) != 1:
        raise AssertionError("the fused run's meshing wrote no object mesh or left no valid "
                             "object state")

    snap = meshing_snapshot(params, scene)
    meshes = {}
    for nid in scene.node_ids:
        with timed_sdf_queries() as spent:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = (mesh_object_cano(snap[nid], scene) if nid == "object"
                 else mesh_hand_cano(snap[nid], scene, nid))
            wall = time.perf_counter() - t0
        shown = "no surface" if m is None else (f"{m.vertices.shape[0]} vertices, "
                                                f"{m.faces.shape[0]} faces")
        print(f"  meshing {nid}: wall {wall * 1e3:.3f} ms = SDF queries on the device "
              f"{spent[0] * 1e3:.3f} ms ({spent[2]} points in {spent[1]} batches) + MISE on "
              f"the host {(wall - spent[0]) * 1e3:.3f} ms; {shown}", flush=True)
        meshes[nid] = m
    obj = meshes["object"]
    if obj is None or obj.faces.shape[0] == 0:
        raise AssertionError("the object's field gave no mesh")
    t0 = time.perf_counter()
    state = object_mesh_state_from_mesh(obj.vertices, obj.faces, dev)
    kept = int((state["bound_centers"][:, 0] < 1e4).sum())
    print(f"  object mesh state: valid {float(state['valid']):.0f}, {kept} bound rows of "
          f"{state['bound_centers'].shape[0]}, h_margin {float(state['h_margin']):.5f} "
          f"({(time.perf_counter() - t0) * 1e3:.3f} ms)", flush=True)
    if float(state["valid"]) != 1.0:
        raise AssertionError("the object's mesh gave an invalid mesh state")

    states = {"valid 1": state, "valid 0": empty_object_mesh_state(dev)}
    batch = batch_to_device(seq.sample_tempo_batch(np.random.RandomState(9), BATCH_SIZE, 1,
                                                   RAYS_PER_FRAME), dev)
    B, P = batch["uv"].shape[:2]
    step = STEPS
    z = sample_all_z(params, scene, batch, torch.Generator(dev).manual_seed(9), step, step)
    for name, st in states.items():
        draws = sample_step_draws(scene, B, P, torch.Generator(dev).manual_seed(9))
        out = holdnet_forward(params, scene, batch, st, draws, step, step, z_vals_dict=z)
        off = out["object.index_off_surface"]
        sparse = float((out["object.active"]
                        * opacity_sparse_loss(out["object.mask_prob"], off)).detach())
        eik = float((out["object.active"] * eikonal_loss(out["object.grad_theta"])).detach())
        ok = (sparse > 0 and eik > 0) if st is state else (sparse == 0 and eik == 0)
        print(f"  {name}: the object's sparse term {sparse:.6e} ({int(off.sum())} of "
              f"{off.numel()} rays off its surface), eikonal term {eik:.6e} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"{name}: the object's sparse and eikonal terms are not "
                                 f"{'on' if st is state else 'off'}")
        del out

    opt = optimizer_for(args, params)
    gen = torch.Generator(dev).manual_seed(11)
    rng = np.random.RandomState(11)
    for name, st in states.items():
        timer = StepTimer()
        train_step = make_train_step(scene, opt, timer)
        for i in range(3):
            batch = batch_to_device(seq.sample_tempo_batch(rng, BATCH_SIZE, 1, RAYS_PER_FRAME),
                                    dev)
            aux = train_step(params, batch, st, gen, step + i, step + i)
            bad = {k: float(v) for k, v in aux.items() if not math.isfinite(float(v))}
            if bad:
                raise AssertionError(f"{name}: non-finite losses {bad}")
            if i == 0:  # the means leave out the first step
                timer.totals.clear()
                timer.counts.clear()
        summ = timer.summary()
        print(f"  3 steps with the object state at {name}: loss {float(aux['loss']):.5f}, "
              f"grad_ms {summ['grad'] * 1e3:.3f}, sampler_ms {summ['sampler'] * 1e3:.3f} "
              f"(steps 2-3)", flush=True)


# kernel families of the device time: (family, substrings of kernel names)
FAMILIES = (
    ("fused_shade fwd", ("fused_shade_fwd_kernel",)),
    ("fused_shade bias sums", ("fused_shade_bwd_kernel_sums",)),
    ("fused_shade bwd rows", ("fused_shade_bwd_kernel",)),
    ("fused_shade wgrad", ("wgrad_kernel",)),
    ("fused_render warp", ("render_warp_kernel",)),
    ("fused_render shade", ("render_shade_kernel",)),
    ("fused_query warp", ("query_embed_kernel",)),
    ("fused_query trunk", ("query_trunk_kernel",)),
    ("knn", ("knn_", "min_vertex_dist")),
    ("gemm", ("gemm", "xmma", "cutlass", "sm90_")),
    ("memcpy", ("memcpy", "memset")),
    ("elementwise", ("elementwise", "vectorized")),
    ("reduce", ("reduce",)),
)


def device_split(torch, prof) -> tuple:
    """Device time (ms) and launches by kernel family from a profile."""
    fams = {f: [0.0, 0] for f, _ in FAMILIES}
    fams["other"] = [0.0, 0]
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = e.name.lower()
        fam = next((f for f, keys in FAMILIES if any(k in name for k in keys)), "other")
        fams[fam][0] += e.time_range.elapsed_us() / 1e3
        fams[fam][1] += 1
    total = sum(ms for ms, _ in fams.values())
    split = ", ".join(f"{k} {ms:.3f} ms / {n}" for k, (ms, n) in fams.items() if n)
    return total, sum(n for _, n in fams.values()), split


def sampler_exponentials_cost(torch, seq, args, scene, params, dev) -> None:
    """Phase 5, report only: the sampler stage at the slice's batch as it
    is (its exponentials in float64, the error-bound kernels) and with its
    plain steps' exponentials in float32 (as before the repair): the mean
    wall of 5 synchronised calls each, alternating, and one call's launches
    and device time under torch.profiler."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from hold_tpu_torch.models.holdnet import sample_all_z
    from hold_tpu_torch.train import batch_to_device

    batch = batch_to_device(seq.sample_tempo_batch(np.random.RandomState(6), BATCH_SIZE, 1,
                                                   int(args["num_sample"])), dev)
    gen = torch.Generator(dev).manual_seed(6)
    step = int(args["total_step"])
    modes = {"float64": contextlib.nullcontext, "float32": lambda: float32_exponentials(torch)}
    walls = {m: [] for m in modes}
    for _ in range(6):
        for m, ctx in modes.items():
            with ctx():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sample_all_z(params, scene, batch, gen, step, 0)
                torch.cuda.synchronize()
                walls[m].append(time.perf_counter() - t0)
    for m, ctx in modes.items():
        with ctx(), profile(activities=[ProfilerActivity.CUDA]) as prof:
            sample_all_z(params, scene, batch, gen, step, 0)
            torch.cuda.synchronize()
        dev_ms, n, _ = device_split(torch, prof)
        print(f"  sampler with {m} exponentials: sampler_ms {np.mean(walls[m][1:]) * 1e3:.3f} "
              f"(mean of 5 after a warm-up), {n} launches, device {dev_ms:.3f} ms", flush=True)


def train_profile(torch, seq, args, scene, params, mesh_state, dev, summ) -> None:
    """Phase 5, report only: one more step of the run's path under
    torch.profiler, its sampler and grad stages profiled apart; device time
    and launches by kernel family, and the busy share, device time over the
    run's mean unprofiled stage wall."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from hold_tpu_torch.models.holdnet import holdnet_forward, sample_all_z, sample_step_draws
    from hold_tpu_torch.models.losses import compute_losses
    from hold_tpu_torch.train import batch_to_device, optimizer_for

    opt = optimizer_for(args, params)
    batch = batch_to_device(seq.sample_tempo_batch(np.random.RandomState(5), BATCH_SIZE, 1,
                                                   int(args["num_sample"])), dev)
    B, P = batch["uv"].shape[:2]
    gen = torch.Generator(dev).manual_seed(5)
    step = int(args["total_step"])

    def sampler():
        return sample_all_z(params, scene, batch, gen, step, 0)

    def grad(z):
        draws = sample_step_draws(scene, B, P, gen)
        opt.zero_grad(set_to_none=True)
        out = holdnet_forward(params, scene, batch, mesh_state, draws, step, 0, z_vals_dict=z)
        compute_losses(batch, out, scene.node_ids, step)["loss"].backward()
        opt.step()

    z = sampler()
    grad(z)
    torch.cuda.synchronize()
    for stage, fn in (("sampler", sampler), ("grad", lambda: grad(z))):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        total, n, split = device_split(torch, prof)
        if not total:
            print(f"  {stage} device split: not measured (the profiler saw no device events)")
            continue
        print(f"  {stage} device split (torch.profiler, one step): {split}; device total "
              f"{total:.3f} ms in {n} launches, busy share {total / (summ[stage] * 1e3):.3f} of "
              f"the {summ[stage] * 1e3:.3f} ms stage", flush=True)


def render_slice(torch, seq, data_root, args, dev) -> dict:
    """Phase 6: render_cli on the fused run's checkpoint, from counters at 0;
    checks the maps and the launches, prints the frame times; then one chunk
    with the chunked render shade, held to PSNR_FLOOR; then the frames over
    two ranks (``two_rank_render``).  Returns the counts by path ("render",
    "render_rank0", "render_rank1")."""
    import numpy as np

    from hold_tpu_torch import render_cli
    from hold_tpu_torch.ops import fused_query, fused_render, fused_shade, knn, point_mesh
    from hold_tpu_torch.render.renderer import make_chunk_renderer
    from hold_tpu_torch.utils.checkpoint import load_experiment

    exp = os.path.join(args["log_root"], args["exp_key"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mods = (knn, point_mesh, fused_query, fused_render, fused_shade)
    for mod in mods:
        mod.reset_launch_counts()
    records = render_cli.main([
        "--exp", exp, "--case", "synthetic", "--data_root", data_root,
        "--render_downsample", str(RENDER_DOWNSAMPLE), "--pixel_per_batch", str(PIXEL_PER_BATCH),
        "--num_agents", str(FRAMES // RENDER_FRAMES), "--agent_id", "0",
        "--out", os.path.join(args["log_root"], "renders"),
        "--export_root", os.path.join(args["log_root"], "exports"), "--device", dev.type,
    ])
    torch.cuda.synchronize()
    launches = {k: v for mod in mods for k, v in mod.LAUNCHES.items()}
    peak = torch.cuda.max_memory_allocated()
    if len(records) != RENDER_FRAMES:
        raise AssertionError(f"rendered {len(records)} frames, expected {RENDER_FRAMES}")
    for rec in records:
        res = rec["res"]
        bad = [k for k, v in res.items() if not np.isfinite(v).all()]
        if bad or res["rgb"].shape[:2] != (IMG_HW[0] // RENDER_DOWNSAMPLE,
                                           IMG_HW[1] // RENDER_DOWNSAMPLE):
            raise AssertionError(f"frame {rec['idx']}: non-finite {bad} or shape "
                                 f"{res['rgb'].shape}")
        rays = res["rgb"].shape[0] * res["rgb"].shape[1]
        ph = rec["phases"]
        print(f"  frame {rec['idx']}: render_ms {rec['seconds'] * 1e3:.3f} (sampler "
              f"{ph['sampler'] * 1e3:.3f}, shade {ph['shade'] * 1e3:.3f}), rays_per_s "
              f"{rays / rec['seconds']:.1f} ({rays} rays, mask mean "
              f"{float(res['mask_prob'].mean()):.4f})", flush=True)
    print(f"  max_memory_allocated_bytes {peak} ({peak / 2**30:.3f} GiB)")
    print(f"  launches: {launches}")
    missing = [k for k, (_, _, paths) in KERNELS.items() if "render" in paths and launches[k] == 0]
    stray = [k for k, (_, _, paths) in KERNELS.items() if "render" not in paths and launches[k]]
    if missing or stray:
        raise AssertionError(f"render run: not launched {missing}, launched off its path {stray}")

    batch, pix = render_batch(torch, seq, dev, PIXEL_PER_BATCH)
    res0 = records[0]["res"]  # frame 0
    # the chunked render shade in float32 (the reading PSNR_FLOOR was set
    # on), then in bf16 (the card's default)
    for f32 in (True, False):
        params, scene, _ = load_experiment(exp, seq, dev, fused_render=False, shade_f32=f32)
        if [p.shade_bf16 for p in scene.plans.values()] != [not f32] * len(scene.plans):
            raise AssertionError("the chunked render shade's precision is not the one asked for")
        layer = make_chunk_renderer(scene)(params, batch)
        mse = float(np.mean((layer["rgb"].cpu().numpy() - res0["rgb"].reshape(-1, 3)[pix]) ** 2))
        psnr = -10.0 * math.log10(max(mse, 1e-20))
        d_n = np.abs(layer["normal"].cpu().numpy() - res0["normal"].reshape(-1, 3)[pix])
        mask = float(layer["mask_prob"].mean())
        ok = psnr >= PSNR_FLOOR and mask >= MASK_FLOOR
        print(f"  one chunk (hand and object pixels first), fused render vs chunked "
              f"{'f32' if f32 else 'bf16'} shade: rgb PSNR {psnr:.2f} dB (floor {PSNR_FLOOR}); "
              f"mean mask_prob {mask:.4f} (floor {MASK_FLOOR}) {'ok' if ok else 'FAIL'}; normal "
              f"map |d| max {d_n.max():.3e} mean {d_n.mean():.3e}", flush=True)
        if not ok:
            raise AssertionError("the fused render disagrees with the chunked render shade, or "
                                 "the chunk misses the hand and the object")
    render_profile(torch, seq, exp, dev, sum(r["seconds"] for r in records) / len(records))
    return {"render": launches, **two_rank_render(torch, args, data_root, records, dev)}


def render_rank(rank: int, world: int, device, args) -> dict:
    """One rank of phase 6's render over two ranks (``render_cli.render_on``'s
    worker): ``render_cli.render_worker`` from counters at 0, with the
    rank's launches."""
    import torch

    from hold_tpu_torch import render_cli

    reset_kernel_launches()
    records = render_cli.render_worker(rank, world, device, args)
    torch.cuda.synchronize()
    return {"records": records, "launches": kernel_launches()}


def two_rank_render(torch, args, data_root: str, records: list, dev) -> dict:
    """Phase 6: ``render_cli.render_on`` over ["cuda:0", "cuda:0"] (two gloo
    ranks sharing the card, each chunk's pixels split over them) on the
    same frames as the one-process run (``records``): every map, the PNG
    panels and the fp16 normals must equal that run's bit for bit; both
    ranks' walls and launches.  Returns the launches by rank."""
    import argparse

    import numpy as np

    from hold_tpu_torch import render_cli

    out = os.path.join(args["log_root"], "renders_two_ranks")
    exports = os.path.join(args["log_root"], "exports_two_ranks")
    exp = os.path.join(args["log_root"], args["exp_key"])
    cli = argparse.Namespace(
        exp=exp, case="synthetic", data_root=data_root, render_downsample=RENDER_DOWNSAMPLE,
        agent_id=0, num_agents=FRAMES // RENDER_FRAMES, pixel_per_batch=PIXEL_PER_BATCH,
        out=out, export_root=exports, device="cuda", no_fused_render=False)
    t0 = time.perf_counter()
    ranks = render_cli.render_on(cli, [str(dev), str(dev)], backend="gloo", worker=render_rank,
                                 timeout=600)
    print(f"  two gloo ranks on one card: {time.perf_counter() - t0:.1f} s with their start",
          flush=True)
    failed = []
    for r, res in enumerate(ranks):
        print(f"  rank {r}: frames " + ", ".join(
            f"{rec['idx']} {rec['seconds'] * 1e3:.3f} ms (sampler {rec['phases']['sampler'] * 1e3:.3f}"
            f", shade {rec['phases']['shade'] * 1e3:.3f})" for rec in res["records"])
            + f"; launches {res['launches']}", flush=True)
        failed += path_check(f"render_rank{r}", res["launches"])
        for rec, ref in zip(res["records"], records):
            diff = {k: float(np.abs(rec["res"][k].astype(np.float64) - v).max())
                    for k, v in ref["res"].items()}
            same = all(np.array_equal(rec["res"][k], v) for k, v in ref["res"].items())
            print(f"    frame {rec['idx']}: every map bit for bit the one-process run's {same}"
                  f"{'' if same else f'; max |d| {diff}'}", flush=True)
            if not same or rec["idx"] != ref["idx"]:
                failed.append(f"rank {r} frame {rec['idx']}")
    one_out = os.path.join(args["log_root"], "renders")
    one_exports = os.path.join(args["log_root"], "exports")
    name = os.path.basename(exp)
    for rec in records:
        files = [(os.path.join(one_out, f"{rec['idx']:04d}.png"),
                  os.path.join(out, f"{rec['idx']:04d}.png")),
                 (os.path.join(one_exports, name, "normal", f"{rec['idx']:04d}.npy"),
                  os.path.join(exports, name, "normal", f"{rec['idx']:04d}.npy"))]
        for a, b in files:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                same = fa.read() == fb.read()
            print(f"    {os.path.basename(b)}: the file bit for bit the one-process run's {same}",
                  flush=True)
            if not same:
                failed.append(b)
    if failed:
        raise AssertionError(f"the render over two ranks differs from one process: {failed}")
    return {f"render_rank{r}": res["launches"] for r, res in enumerate(ranks)}


def render_profile(torch, seq, exp: str, dev, frame_s: float) -> None:
    """Phase 6, report only: one more frame of the fused render under
    torch.profiler; device time and launches by kernel family, and the busy
    share, device time over ``frame_s`` (the unprofiled frames' mean wall)."""
    from torch.profiler import ProfilerActivity, profile

    from hold_tpu_torch.render.renderer import make_chunk_renderer, render_frame
    from hold_tpu_torch.utils.checkpoint import load_experiment

    params, scene, _ = load_experiment(exp, seq, dev)
    fb = seq.full_frame_batch(0, downsample=RENDER_DOWNSAMPLE)
    chunk_fn = make_chunk_renderer(scene)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        render_frame(params, scene, fb, PIXEL_PER_BATCH, chunk_fn)
        torch.cuda.synchronize()
    total, n, split = device_split(torch, prof)
    if not total:
        print("  device split of a frame: not measured (the profiler saw no device events)")
        return
    print(f"  device split of a frame (torch.profiler): {split}; device total {total:.3f} ms in "
          f"{n} launches, busy share {total / (frame_s * 1e3):.3f} of the {frame_s * 1e3:.3f} ms "
          f"frame", flush=True)


# evaluate.EVAL_FN_DICT's entries (and the ICP, run when the prediction has
# the object's mesh) -> the metrics each writes to eval.metric.json
EVAL_KEYS = {"mpjpe_ra_r": ("mpjpe_ra_r",), "mrrpe_ho": ("mrrpe_ho",),
             "cd_f_ra": ("cd_ra", "f5_ra", "f10_ra"),
             "cd_f_right": ("cd_right", "f5_right", "f10_right"),
             "icp": ("cd_icp", "f5_icp", "f10_icp")}
NOISE = 0.3  # pose_noise of phase 7's noised sequence


def evaluation(torch, data_root: str, args, cfg, dev) -> None:
    """Phase 7: ``hold_tpu_torch.evaluate`` on the fused run's experiment
    against the synthetic ground truth, at the default ICP restarts: every
    metric of EVAL_KEYS finite in eval.metric.json, no kernel launched (the
    servers are plain PyTorch on the card, the ICP numpy on the host).  Then
    a sequence made with ``pose_noise``, 2 steps of training from its noised
    poses, and evaluate against its ``entities_gt``: the metrics of
    EVAL_FN_DICT finite (the run does not mesh: no ICP), and the hand's
    error above the clean run's."""
    from hold_tpu_torch import evaluate
    from hold_tpu_torch.data.dataset import SequenceData
    from hold_tpu_torch.data.synthetic import generate_sequence
    from hold_tpu_torch.ops import fused_query, fused_render, fused_shade, knn, point_mesh
    from hold_tpu_torch.train import run_training
    from hold_tpu_torch.utils.config import Cfg

    if set(EVAL_KEYS) - {"icp"} != set(evaluate.EVAL_FN_DICT):
        raise AssertionError(f"EVAL_FN_DICT is {sorted(evaluate.EVAL_FN_DICT)}")
    mods = (knn, point_mesh, fused_query, fused_render, fused_shade)

    def run(exp, case, keys):
        for mod in mods:
            mod.reset_launch_counts()
        t0 = time.perf_counter()
        rec = evaluate.main(["--exp", exp, "--case", case, "--data_root", data_root,
                             "--device", dev.type])
        wall = time.perf_counter() - t0
        launched = {k: v for mod in mods for k, v in mod.LAUNCHES.items() if v}
        with open(os.path.join(exp, "eval.metric.json")) as f:
            written = json.load(f)
        names = [m for k in keys for m in EVAL_KEYS[k]]
        bad = [m for m in names if not math.isfinite(written.get(m, float("nan")))]
        print(f"  {case}: wall {wall * 1e3:.3f} ms = checkpoint, servers on the card and eval "
              f"space {rec['servers_s'] * 1e3:.3f} ms + metrics and ICP on the host "
              f"{rec['metrics_s'] * 1e3:.3f} ms (+ reading the sequence); "
              f"{ {m: written.get(m) for m in names} }", flush=True)
        if bad or launched:
            raise AssertionError(f"{case}: metrics not finite {bad}, kernels launched {launched}")
        return written

    clean = run(os.path.join(args["log_root"], args["exp_key"]), "synthetic", list(EVAL_KEYS))
    generate_sequence(os.path.join(data_root, "synthetic_noisy"), FRAMES, IMG_HW,
                      pose_noise=NOISE)
    seq = SequenceData.from_build_dir("synthetic_noisy", data_root, num_sample=RAYS_PER_FRAME)
    noisy_args = Cfg({**args, "case": "synthetic_noisy", "exp_key": "chip_smoke_noisy"})
    run_training(noisy_args, cfg, seq=seq, max_steps=2, device=dev)
    noisy = run(os.path.join(args["log_root"], "chip_smoke_noisy"), "synthetic_noisy",
                list(evaluate.EVAL_FN_DICT))
    ok = noisy["mpjpe_ra_r"] > clean["mpjpe_ra_r"]
    print(f"  mpjpe_ra_r: noised init ({NOISE}) {noisy['mpjpe_ra_r']:.4f} mm against its "
          f"truth, clean run {clean['mpjpe_ra_r']:.4f} mm {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("the noised sequence is not evaluated against its truth")


REFINE_ITERS = 4  # optimize_ckpt --iters in phase 8 (the CLI's default is 500)
REFINE_STEP = 8  # the fused run's checkpoint that phase 8 refines (resumed to step 8)
REFINE_ICP_ITERS = 40  # evaluate --icp_iters on the refined checkpoint (phase 7 runs 600)
# card against CPU (phase 8): FittingProblem on 2 frames with masks scaled
# to this longer side (36x48 of the 240x320 sequence)
AGREE_TARGET_DIM = 48
# ... the loss terms within FIT_LOSS_RTOL of the CPU's, each free leaf's
# gradient within FIT_GRAD_TOL of the CPU's largest element of that leaf,
# and 5 iterations of run_fit's loss history within FIT_HIST_RTOL: both
# devices render the same near-binary silhouettes (sigma 1e-6) and differ
# by the rounding of exp / log1p and of the sums' order
FIT_LOSS_RTOL, FIT_GRAD_TOL, FIT_HIST_RTOL = 1e-4, 1e-3, 1e-3
# the generator's loops, card against CPU: outputs and loss histories
GEN_TOL = 1e-3


def kernel_launches() -> dict:
    from hold_tpu_torch.ops import fused_query, fused_render, fused_shade, knn, point_mesh

    return {k: v for mod in (knn, point_mesh, fused_query, fused_render, fused_shade)
            for k, v in mod.LAUNCHES.items()}


def reset_kernel_launches() -> None:
    from hold_tpu_torch.ops import fused_query, fused_render, fused_shade, knn, point_mesh

    for mod in (knn, point_mesh, fused_query, fused_render, fused_shade):
        mod.reset_launch_counts()


def truth_problem(torch, seq, frames, target_dim, dev):
    """A FittingProblem on a synthetic sequence's truth (its entities'
    poses, its masks scaled to ``target_dim``), with the object moved 1 cm
    along x so that the fit has work; (problem, parameters)."""
    import numpy as np

    from hold_tpu_torch.fitting.fit import FittingProblem, build_fit_params, load_contact_idx
    from hold_tpu_torch.mano.server import build_mano_server
    from hold_tpu_torch.models.object_model import build_object_server
    from hold_tpu_torch.optimize_ckpt import entity_masks, scale_masks_K

    ent = seq.entities
    nids = seq.hand_ids + ["object"]
    o = ent["object"]
    servers = {h: build_mano_server(h == "right", ent[h]["mean_shape"], device=dev)
               for h in seq.hand_ids}
    servers["object"] = build_object_server(o["pts.cano"], float(o["obj_scale"]), o["norm_mat"],
                                            dev)
    faces = {h: np.asarray(servers[h].consts.faces) for h in seq.hand_ids}
    faces["object"] = o["faces"]
    w2c = np.stack([np.linalg.inv(e) for e in seq.extrinsics_all]).astype(np.float32)
    masks, K, imsize = scale_masks_K(seq.masks[frames], seq.intrinsics_all[0][:3, :3],
                                     target_dim)
    prob = FittingProblem(servers, faces, entity_masks(masks, nids), w2c[frames], K, seq.scale,
                          imsize, load_contact_idx())
    tables = {h: {"betas": ent[h]["mean_shape"][None], "global_orient": ent[h]["hand_poses"][:, :3],
                  "pose": ent[h]["hand_poses"][:, 3:], "transl": ent[h]["hand_trans"]}
              for h in seq.hand_ids}
    tables["object"] = {"global_orient": o["object_poses"][:, :3],
                        "transl": o["object_poses"][:, 3:] + np.array([0.01, 0.0, 0.0])}
    return prob, build_fit_params(tables, nids, float(o["obj_scale"]), frames, dev)


def fit_agreement(torch, seq, label: str, dev) -> None:
    """Phase 8, card against CPU: one FittingProblem on 2 frames at
    AGREE_TARGET_DIM, its loss terms and every free leaf's gradient (stage
    1's leaves: betas and obj_scale free too), then run_fit for 5
    iterations (stage 2's leaves), the loss histories."""
    from hold_tpu_torch.fitting.fit import fit_labels, run_fit, trainable_copy

    frames = [0, 6]
    out = []
    for device in (dev, torch.device("cpu")):
        prob, params = truth_problem(torch, seq, frames, AGREE_TARGET_DIM, device)
        two = len(prob.hand_ids) == 2

        def loss_fn(p):
            o = prob.forward(p)
            if two:
                with torch.no_grad():
                    j2d = {f: prob.project_verts(o[f"{f}.v3d_c"]) + 0.5 for f in prob.hand_ids}
                d = prob.loss_two_hands(o, j2d)
            else:
                d = prob.loss_single_hand(o, "right")
            return d["loss"], {k: float(v.detach()) for k, v in d.items()}

        leaves, _ = trainable_copy(params, fit_labels(params, False, False))
        loss, terms = loss_fn(leaves)
        loss.backward()
        free = {}
        for nid, v in leaves.items():
            for k, x in (v.items() if isinstance(v, dict) else [("", v)]):
                if x.requires_grad:
                    free[f"{nid}.{k}" if k else nid] = x.grad.cpu()
        hist = run_fit(prob, params, True, True, num_iterations=5)[1]
        out.append((terms, free, hist))
    (t_c, g_c, h_c), (t_h, g_h, h_h) = out
    loss_err = max(abs(t_c[k] - v) / max(abs(v), 1e-12) for k, v in t_h.items())
    grad_err = {k: float((g_c[k] - v).abs().max() / v.abs().max().clamp(min=1e-30))
                for k, v in g_h.items()}
    hist_err = max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(h_c, h_h))
    ok = (loss_err <= FIT_LOSS_RTOL and max(grad_err.values()) <= FIT_GRAD_TOL
          and hist_err <= FIT_HIST_RTOL and len(h_c) == len(h_h) == 5)
    print(f"  {label}, card vs CPU (frames {frames}, masks at {AGREE_TARGET_DIM}): loss terms "
          f"{loss_err:.2e} (rtol {FIT_LOSS_RTOL}), free leaves' gradients "
          f"{ {k: f'{v:.2e}' for k, v in grad_err.items()} } (tol {FIT_GRAD_TOL} of the "
          f"largest), run_fit 5 iterations' losses {hist_err:.2e} (rtol {FIT_HIST_RTOL}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{label}: the card's fitting problem disagrees with the CPU's")


def generator_loops(torch, seq, dev) -> None:
    """Phase 8: the generator's two fitting loops at the sequence's frame
    count, card against CPU, timed on the card: fit_mano_to_verts on the
    right hand's vertices at its true poses (10 coarse + 10 fine steps),
    then AlignmentProblem.fit in modes h, o (the scale unlocking at 5 of
    10) and ho (5) on the truth's projected joints and object points."""
    import numpy as np

    from hold_tpu_torch.generator.align import AlignmentProblem, project
    from hold_tpu_torch.generator.register_mano import fit_mano_to_verts
    from hold_tpu_torch.mano.server import build_mano_server, mano_server_forward
    from hold_tpu_torch.models.object_model import build_object_server, object_server_forward

    ent = seq.entities
    n = seq.n_frames
    cpu = torch.device("cpu")
    with torch.no_grad():
        srv = build_mano_server(True, ent["right"]["mean_shape"])
        hp = torch.as_tensor(ent["right"]["hand_poses"])
        hand = mano_server_forward(srv, torch.ones(n), torch.as_tensor(ent["right"]["hand_trans"]),
                                   hp, torch.zeros((n, 10)))
        o = ent["object"]
        obj = object_server_forward(build_object_server(o["pts.cano"], float(o["obj_scale"]),
                                                        o["norm_mat"]), torch.ones(n),
                                    torch.as_tensor(o["object_poses"][:, 3:]),
                                    torch.as_tensor(o["object_poses"][:, :3]))
    K = seq.intrinsics_all[0][:3, :3].astype(np.float32)
    Kt = torch.as_tensor(K)
    j2d = project(Kt, hand.jnts).numpy()
    o2d = project(Kt, obj.verts).numpy()
    verts = hand.verts.numpy()
    res = []
    for device in (dev, cpu):
        t0 = time.perf_counter()
        fit = fit_mano_to_verts(verts, True, coarse_iters=10, fine_iters=10, device=device)
        t_reg = time.perf_counter() - t0
        prob = AlignmentProblem({"right": j2d}, o2d, o["pts.cano"] * float(o["obj_scale"]), K,
                                device=device)
        p = prob.init_params(n, {"right": {"pose": ent["right"]["hand_poses"][:, 3:]}})
        hists, walls = [], []
        for mode, kw in (("h", dict(iters=10)), ("o", dict(iters=10, scale_unlock_at=5)),
                         ("ho", dict(iters=5))):
            t0 = time.perf_counter()
            p = prob.fit(p, mode, **kw)
            if device.type == "cuda":
                torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3 / kw["iters"])
            hists += prob.history
        res.append((fit, hists, t_reg * 1e3 / 20, walls))
    (fit_c, h_c, reg_ms, walls), (fit_h, h_h, _, _) = res
    reg_err = max(float(np.abs(fit_c[k] - v).max()) for k, v in fit_h.items())
    hist_err = max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(h_c, h_h))
    ok = reg_err <= GEN_TOL and hist_err <= GEN_TOL and all(map(math.isfinite, h_c))
    print(f"  fit_mano_to_verts ({n} frames, 20 steps): card vs CPU {reg_err:.2e}, vertex error "
          f"{float(fit_c['vert_err'].mean()):.2e}, {reg_ms:.3f} ms a step on the card (with its "
          f"setup); AlignmentProblem.fit h / o / ho: losses card vs CPU {hist_err:.2e} (tol "
          f"{GEN_TOL}), {' / '.join(f'{w:.3f}' for w in walls)} ms an iteration on the card "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("the generator's fitting loops disagree card vs CPU")


def refined_checkpoint_checks(torch, exp: str, src_path: str, path: str, seq, dev,
                              fits: list) -> None:
    """Phase 8: the refined checkpoint is step 999,000,000, the newest, read
    by ``load_experiment``, finite; every tensor but the free tables and
    obj_scale is the source's bit for bit (the hands' pose and global
    orient too); betas and obj_scale are stage 1's result (the source's when
    it was rejected); stage 2's translations and the object's orientation
    are each batch's fit where it was kept and the source's where not; the
    fit-visualisation GIFs are written.  ``fits``: each run_fit call's
    (frames, wall, returns), stage 1 first."""
    from hold_tpu_torch.optimize_ckpt import STEP_TAG
    from hold_tpu_torch.utils.checkpoint import load_experiment, read_checkpoint

    want = os.path.join(exp, "checkpoints", f"step_{STEP_TAG:09d}.pt")
    if path != want or not os.path.isfile(want):
        raise AssertionError(f"no refined checkpoint {want}")
    _, _, step = load_experiment(exp, seq, dev)
    state, src = read_checkpoint(want)["params"], read_checkpoint(src_path)["params"]
    if step != STEP_TAG or not all(bool(torch.isfinite(v).all()) for v in state.values()):
        raise AssertionError("the refined checkpoint is not the newest or not finite")
    (_, _, (p1, _, kept1, _)), stage2 = fits[0], fits[1:]
    stage1 = {"right/tables/betas": p1["right"]["betas"] if kept1 else src["right/tables/betas"],
              "object/obj_scale": p1["obj_scale"] if kept1 else src["object/obj_scale"]}
    bad = [k for k, v in src.items() if "/tables/" not in k and k != "object/obj_scale"
           and not torch.equal(state[k], v)]
    bad += [k for k in ("right/tables/pose", "right/tables/global_orient")
            if not torch.equal(state[k], src[k])]
    bad += [k for k, v in stage1.items() if not torch.equal(state[k], v.cpu().reshape(
        state[k].shape))]
    frame = 0
    for f, _, (p2, _, kept, _) in stage2:
        idx = slice(frame, frame + f)
        for k in ("right/tables/transl", "object/tables/transl", "object/tables/global_orient"):
            nid, leaf = k.split("/")[0], k.split("/")[-1]
            ref = p2[nid][leaf].cpu() if kept else src[k][idx]
            if not torch.equal(state[k][idx], ref):
                bad.append(f"{k}[{idx.start}:{idx.stop}]")
        frame += f
    gifs = sorted(os.listdir(os.path.join(exp, "fit_vis")))
    print(f"  refined checkpoint: step {step}, stage 1 {'kept' if kept1 else 'rejected'}, "
          f"stage 2 {[r[2] for _, _, r in stage2]}; fit_vis {gifs}", flush=True)
    if bad or frame != seq.n_frames:
        raise AssertionError(f"the refinement moved what it must not, or kept what it "
                             f"rejected: {bad}")
    if gifs != ["stage1.gif", "stage2_0000.gif", "stage2_0010.gif"]:
        raise AssertionError(f"fit_vis holds {gifs}")


def fit_iteration_cost(torch, prob, params) -> None:
    """Phase 8: one fit iteration (forward, backward with the chunks
    recomputed, Adam) on the refinement's own first stage-2 problem (10
    frames, masks at ``--target_dim``, the object decimated as the CLI
    does), from that batch's input: the wall (synchronised) of a forward
    alone, then wall and peak memory of one iteration, then device time and
    launches by kernel family (torch.profiler over a second one)."""
    from torch.profiler import ProfilerActivity, profile

    from hold_tpu_torch.fitting.fit import fit_labels, trainable_copy

    p, free = trainable_copy(params, fit_labels(params, True, True))
    opt = torch.optim.Adam(free, lr=1e-2, eps=1e-8)

    def iteration():
        opt.zero_grad()
        prob.loss_single_hand(prob.forward(p), "right")["loss"].backward()
        opt.step()

    # no warm-up: the refinement ran the same shapes just before
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        prob.forward(p)
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    iteration()
    torch.cuda.synchronize()
    it_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        iteration()
        torch.cuda.synchronize()
    dev_ms, n_launch, split = device_split(torch, prof)
    print(f"  a fit iteration at the 10-frame batch ({prob.imsize[0]}x{prob.imsize[1]} masks, "
          f"faces { {k: len(v) for k, v in prob.faces.items()} }): a forward {fwd_ms:.3f} ms, "
          f"an iteration {it_ms:.3f} ms (synchronised), device {dev_ms:.3f} ms in {n_launch} "
          f"launches ({split}); peak {peak:.3f} GiB", flush=True)


def refinement(torch, data_root: str, args, dev, launches: dict) -> None:
    """Phase 8: ``optimize_ckpt`` on the fused run's checkpoint at step
    REFINE_STEP (the canonical object mesh of its epoch-3 meshing) at the
    CLI's defaults but ``--iters``, GIFs on, each run_fit call timed; the
    refined checkpoint checked (``refined_checkpoint_checks``);
    ``evaluate`` and ``visualize_ckpt`` on it; no kernel of the port
    launched on the refine and visualize paths; then the fit's cost at the
    10-frame batch, the card against the CPU on a small problem (one hand,
    two hands), the generator's loops."""
    from hold_tpu_torch import evaluate, optimize_ckpt, visualize_ckpt
    from hold_tpu_torch.data.dataset import SequenceData
    from hold_tpu_torch.data.synthetic import generate_sequence

    exp = os.path.join(args["log_root"], args["exp_key"])
    src_path = os.path.join(exp, "checkpoints", f"step_{REFINE_STEP:09d}.pt")
    fits = []  # each run_fit call: (frames, wall s, its returns)
    problems = []  # each run_fit call: (problem, its input parameters)
    real_fit = optimize_ckpt.run_fit

    def timed_fit(prob, params, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ret = real_fit(prob, params, *a, **k)
        torch.cuda.synchronize()
        fits.append((prob.w2c.shape[0], time.perf_counter() - t0, ret))
        problems.append((prob, params))
        return ret

    optimize_ckpt.run_fit = timed_fit
    reset_kernel_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        path = optimize_ckpt.main(["--exp", exp, "--case", "synthetic", "--data_root", data_root,
                                   "--iters", str(REFINE_ITERS), "--ckpt", src_path,
                                   "--device", dev.type])
    finally:
        optimize_ckpt.run_fit = real_fit
    wall = time.perf_counter() - t0
    launches["refine"] = kernel_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  refine: {wall * 1e3:.3f} ms in all; run_fit walls (frames: ms, kept) "
          f"{[(f, round(w * 1e3, 3), r[2]) for f, w, r in fits]}; peak {peak:.3f} GiB; "
          f"launches {[k for k, v in launches['refine'].items() if v] or 'none'}", flush=True)
    if any(launches["refine"].values()):
        raise AssertionError(f"refinement launched port kernels: {launches['refine']}")
    seq = SequenceData.from_build_dir("synthetic", data_root)
    refined_checkpoint_checks(torch, exp, src_path, path, seq, dev, fits)

    # evaluation and the viewer on the refined checkpoint
    rec = evaluate.main(["--exp", exp, "--case", "synthetic", "--data_root", data_root,
                         "--device", dev.type, "--icp_iters", str(REFINE_ICP_ITERS),
                         "--out_json", os.path.join(exp, "eval_refined.metric.json")])
    metrics = {k: v for k, v in rec["mean"].items() if isinstance(v, float)}
    print(f"  evaluate on the refined checkpoint (--icp_iters {REFINE_ICP_ITERS}): {metrics}",
          flush=True)
    if not metrics or not all(map(math.isfinite, metrics.values())):
        raise AssertionError("the refined checkpoint's metrics are not finite")
    reset_kernel_launches()
    t0 = time.perf_counter()
    out_dir = visualize_ckpt.main(["--exp", exp, "--case", "synthetic", "--data_root", data_root,
                                   "--device", dev.type])
    vis_ms = (time.perf_counter() - t0) * 1e3
    launches["visualize"] = kernel_launches()
    files = sorted(os.listdir(out_dir))
    pngs = [f for f in files if f.endswith(".png")]
    mp4 = os.path.join(out_dir, "overlay.mp4")
    print(f"  visualize_ckpt: {vis_ms:.3f} ms, {len(pngs)} PNGs, overlay.mp4 "
          f"{os.path.getsize(mp4) if os.path.exists(mp4) else 0} bytes, viewer.html "
          f"{'viewer.html' in files}; launches "
          f"{[k for k, v in launches['visualize'].items() if v] or 'none'}", flush=True)
    if (len(pngs) != seq.n_frames or not os.path.exists(mp4) or os.path.getsize(mp4) == 0
            or "viewer.html" not in files or any(launches["visualize"].values())):
        raise AssertionError("visualize_ckpt's outputs are missing or it launched port kernels")

    fit_iteration_cost(torch, *problems[1])
    t0 = time.perf_counter()
    fit_agreement(torch, seq, "one hand", dev)
    built = generate_sequence(None, FRAMES, IMG_HW, two_hands=True)
    fit_agreement(torch, SequenceData(built["images"], built["masks"], built["data"]),
                  "two hands", dev)
    generator_loops(torch, seq, dev)
    print(f"  card vs CPU checks and the generator's loops: {time.perf_counter() - t0:.1f} s",
          flush=True)


# --------------------------------------------------------------------------
# Phase 9: real-format data
# --------------------------------------------------------------------------

HO3D_FRAMES, HO3D_INVALID = FRAMES, 5  # the raw sequence's frames, the one unannotated
HO3D_OBJECT = "021_bleach_cleanser"
# the card's gt_ho3d bus against the CPU's (metres): float32 MANO layers on
# both, the card's sums in another order; vertices lie within 1 m
GT_BUS_ATOL = 1e-5


def write_ho3d_raw(root: str, seq: str, n_frames: int, invalid: int) -> str:
    """An HO3D v3 sequence in the raw layout (``rgb/NNNN.jpg`` and
    ``meta/NNNN.pkl``, frame ``invalid`` without annotations, as real dropped
    frames are), and the scanned object (a 10 cm cube) in the YCB layout
    under ``<root>/assets/models``.  Returns the sequence's folder."""
    import pickle

    import numpy as np

    seq_dir = os.path.join(root, seq)
    os.makedirs(os.path.join(seq_dir, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(seq_dir, "meta"), exist_ok=True)
    rng = np.random.RandomState(1)
    K = np.array([[614.0, 0, 320.0], [0, 614.0, 240.0], [0, 0, 1]], np.float64)
    for i in range(n_frames):
        with open(os.path.join(seq_dir, "rgb", f"{i:04d}.jpg"), "wb") as f:
            f.write(b"\xff\xd8\xff\xd9")  # jpeg markers; never decoded
        meta = {"handPose": None, "objTrans": None, "handBeta": None, "objName": HO3D_OBJECT}
        if i != invalid:
            meta = {"handPose": rng.randn(48) * 0.1, "handBeta": rng.randn(10) * 0.03,
                    "handTrans": rng.randn(3) * 0.05 + [0, 0, -0.5],
                    "objRot": rng.randn(3, 1) * 0.3, "objTrans": rng.randn(3) * 0.05 + [0, 0, -0.5],
                    "camMat": K, "objName": HO3D_OBJECT}
        with open(os.path.join(seq_dir, "meta", f"{i:04d}.pkl"), "wb") as f:
            pickle.dump(meta, f)
    mdl = os.path.join(root, "assets", "models", HO3D_OBJECT)
    os.makedirs(mdl, exist_ok=True)
    corners = [(x, y, z) for z in (-1, 1) for y in (-1, 1) for x in (-1, 1)]
    tris = [(0, 1, 3), (0, 3, 2), (4, 6, 7), (4, 7, 5), (0, 4, 5), (0, 5, 1), (2, 3, 7), (2, 7, 6),
            (0, 2, 6), (0, 6, 4), (1, 5, 7), (1, 7, 3)]
    with open(os.path.join(mdl, "textured_simple.obj"), "w") as f:
        f.writelines(f"v {0.05 * x} {0.05 * y} {0.05 * z}\n" for x, y, z in corners)
        f.writelines(f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in tris)
    return seq_dir


def real_format_data(torch, data_root: str, args, cfg, dev) -> None:
    """Phase 9: an HO3D v3 raw sequence (HO3D_FRAMES frames, one unannotated)
    through ``process_ho3d``'s CLI; ``evaluate --gt ho3d`` (on the card) on
    the fused run's step-8 checkpoint, every metric finite and no kernel
    launched; the card's ``gt_ho3d`` bus against the CPU's within
    GT_BUS_ATOL; then a sequence built by ``build_dataset.build_from_arrays``
    from the synthetic sequence's frames, masks, cameras and fits, read back
    and trained for 2 steps at the slice's shapes with finite losses."""
    import numpy as np

    from hold_tpu_torch import evaluate
    from hold_tpu_torch.data import process_ho3d
    from hold_tpu_torch.data.dataset import SequenceData, load_K_Rt_from_P
    from hold_tpu_torch.eval import gt_ho3d
    from hold_tpu_torch.generator import build_dataset
    from hold_tpu_torch.utils.config import Cfg

    t0 = time.perf_counter()
    root = os.path.join(ROOT, "logs", "chip_smoke", "ho3d")
    write_ho3d_raw(os.path.join(root, "raw"), "synthetic", HO3D_FRAMES, HO3D_INVALID)
    ho3d_root = os.path.join(root, "raw", "assets")
    npz = process_ho3d.main(["--ho3d_root", os.path.join(root, "raw"), "--seq", "synthetic",
                             "--out", ho3d_root])
    valid = np.load(npz)["is_valid"]
    print(f"  process_ho3d: {npz}, is_valid {valid.tolist()}", flush=True)
    if valid.sum() != HO3D_FRAMES - 1 or valid[HO3D_INVALID]:
        raise AssertionError("process_ho3d's is_valid is not the fixture's")

    exp = os.path.join(args["log_root"], args["exp_key"])
    out_json = os.path.join(exp, "eval_ho3d.metric.json")
    reset_kernel_launches()
    t1 = time.perf_counter()
    rec = evaluate.main(["--exp", exp, "--case", "synthetic", "--data_root", data_root,
                         "--gt", "ho3d", "--ho3d_root", ho3d_root, "--icp_iters",
                         str(REFINE_ICP_ITERS), "--out_json", out_json,
                         "--ckpt", os.path.join(exp, "checkpoints", f"step_{REFINE_STEP:09d}.pt")])
    wall = time.perf_counter() - t1
    launched = {k: v for k, v in kernel_launches().items() if v}
    with open(out_json) as f:
        written = json.load(f)
    metrics = {k: v for k, v in written.items() if isinstance(v, float)}
    print(f"  evaluate --gt ho3d (--icp_iters {REFINE_ICP_ITERS}, on the card): wall "
          f"{wall * 1e3:.3f} ms (servers {rec['servers_s'] * 1e3:.3f}, metrics and ICP "
          f"{rec['metrics_s'] * 1e3:.3f}); {metrics}", flush=True)
    if (set(metrics) != set(rec["per_frame"]) or not all(map(math.isfinite, metrics.values()))
            or launched):
        raise AssertionError(f"--gt ho3d: metrics {metrics}, kernels launched {launched}")

    buses = {label: gt_ho3d.load_data("synthetic", data_root, ho3d_root, device=d)
             for label, d in (("card", dev), ("cpu", torch.device("cpu")))}
    worst = {k: max_err(torch.as_tensor(v), torch.as_tensor(buses["cpu"][k]))
             for k, v in buses["card"].items() if k != "faces"}
    print(f"  gt_ho3d bus, card vs CPU, max |d| (m) {worst} (tol {GT_BUS_ATOL:g})", flush=True)
    if max(worst.values()) > GT_BUS_ATOL or buses["card"]["v3d_c.right"].shape[0] != HO3D_FRAMES:
        raise AssertionError("gt_ho3d: the card's bus and the CPU's disagree")

    # build_dataset from the synthetic sequence's frames, cameras and fits
    src = SequenceData.from_build_dir("synthetic", data_root, num_sample=RAYS_PER_FRAME)
    cams = src.data["cameras"]
    kw = [load_K_Rt_from_P(cams[f"world_mat_{i}"][:3, :4]) for i in range(src.n_frames)]
    w2c = np.stack([np.linalg.inv(c2w) for _, c2w in kw])
    ent = src.entities
    entities = build_dataset.entities_from_fits(
        {h: {"poses": ent[h]["hand_poses"], "betas": ent[h]["mean_shape"],
             "transl": ent[h]["hand_trans"]} for h in src.hand_ids},
        ent["object"]["object_poses"], ent["object"]["pts.cano"], ent["object"]["obj_scale"],
        ent["object"].get("norm_mat"))
    build_dataset.build_from_arrays(os.path.join(data_root, "built"), src.img_paths,
                                    src.mask_paths, kw[0][0][:3, :3], w2c, entities)
    seq = SequenceData.from_build_dir("built", data_root, num_sample=RAYS_PER_FRAME)
    print(f"  build_from_arrays: {seq.n_frames} frames, scale {seq.scale:.6f} (the source's "
          f"{src.scale:.6f}), bounding sphere {seq.scene_bounding_sphere}", flush=True)
    launches, _ = slice_run(torch, seq, Cfg({**args, "case": "built",
                                             "exp_key": "chip_smoke_built"}), cfg, dev, 2,
                            path="built")
    print(f"  phase 9 {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


# --------------------------------------------------------------------------
# Phase 10: data parallel
# --------------------------------------------------------------------------

DP_START = 9000  # the sparse terms' weight min(step, 30000) / 30000 is 0.3
DP_STEPS = 2
DP_WORLD = 2
# the seed state's hand surface: the SDF head's bias set so that the hand's
# canonical sphere (radius 0.6 at init, with every ray inside it and every
# mask_prob 1) cuts the rays; then the ranks' own masked means differ from
# the global one
DP_HAND_RADIUS = 0.05
DP_SDF_BIAS = "right/implicit/layers/8/b"
# two ranks against one process (one card, gloo): the first step's loss
# terms and psnr within DP_LOSS_RTOL of the one process's (relative; the
# parameters are the same there, the ranks only sum their rays in two
# halves); after each step, at most DP_MOVED_SHARE of the parameters'
# elements more than DP_MOVED_AT x lr apart (each rank's fused shade sums
# its bf16 gradient parts over its own points, so the averaged gradient
# differs from one process's by the kernel's rounding, and Adam turns the
# difference into steps); the validation psnr within DP_VAL_RTOL.  Read on
# an H100 over two calls: the split run 1.4-1.5e-7, 0.033-0.035 % and
# 0.94-1.8 % (after steps 1 and 2), 1.6-1.9e-6; the local-mean control
# 8.7-9.1e-2 on the first step; the no-all-reduce control 48-49 % and 58 %
# of the elements.  Each limit lies well above the split run's reading and
# below the control it catches.
DP_LOSS_RTOL = 1e-5
DP_MOVED_AT = 1e-2
DP_MOVED_SHARE = 0.05
DP_VAL_RTOL = 1e-4
DP_VARIANTS = ("split", "local_mean", "no_allreduce")


def dp_args(args, cfg, exp_key: str, vis: bool):
    from hold_tpu_torch.utils.config import Cfg

    # one step an epoch: a checkpoint (and a validation) after every step
    return Cfg({**args, "exp_key": exp_key, "tempo_len": cfg["dataset"]["train"]["batch_size"],
                "eval_every_epoch": 1, "no_vis": not vis, "total_step": DP_START + DP_STEPS})


def dp_worker(rank: int, world: int, device, args, cfg, data_root: str) -> dict:
    """One rank of phase 10 (a process of its own, in a gloo group with the
    other): the three variants in turn, each from its own copy of the seed
    checkpoint.  Returns each variant's kernel launches, its wall and a
    digest of its final parameters."""
    from contextlib import nullcontext
    from unittest import mock

    import torch

    from hold_tpu_torch import train
    from hold_tpu_torch.data.dataset import SequenceData
    from hold_tpu_torch.models.losses import compute_losses

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seq = SequenceData.from_build_dir("synthetic", data_root, num_sample=RAYS_PER_FRAME)
    controls = {
        "split": {},
        # each rank's masked mean over its own rays, averaged over the ranks
        "local_mean": {"compute_losses": lambda b, o, ids, step, split=None:
                       compute_losses(b, o, ids, step, None)},
        # each rank steps on its own gradients
        "no_allreduce": {"average_gradients": lambda params, split: None},
    }
    out = {}
    for name in DP_VARIANTS:
        reset_kernel_launches()
        t0 = time.perf_counter()
        with mock.patch.multiple(train, **controls[name]) if controls[name] else nullcontext():
            run = train.run_training(dp_args(args, cfg, f"dp_{name}", name == "split"), cfg,
                                     seq=seq, device=device)
        params, timer = run[0], run[4]
        if device.type == "cuda":
            torch.cuda.synchronize()
        flat = torch.cat([p.detach().reshape(-1) for p in
                          train.flatten_params(params).values()]).cpu()
        out[name] = {"launches": kernel_launches(), "s": time.perf_counter() - t0,
                     "digest": flat, "phases": timer.summary()}
    return out


def dp_records(log_root: str, key: str) -> dict:
    with open(os.path.join(log_root, key, "metrics.jsonl")) as f:
        return {r["step"]: r for r in map(json.loads, f)}


def dp_gaps(torch, log_root: str, key: str, lr: float) -> dict:
    """Run ``key`` against the one-process run: "loss", {step: the worst
    relative gap of the step's loss terms and psnr}; "max", {step: the
    worst |d| of a parameter after it}; "moved", {step: the share of the
    parameters' elements that lie more than DP_MOVED_AT x lr apart after
    it}; "val", the validation psnrs' worst relative gap (None without)."""
    from hold_tpu_torch.utils.checkpoint import read_checkpoint

    ref, got = dp_records(log_root, "dp_one"), dp_records(log_root, key)
    out = {"loss": {s: max(abs(got[s][k] - v) / max(abs(v), 1e-12) for k, v in ref[s].items()
                           if k.startswith("loss") or k == "psnr")
                    for s in range(DP_START, DP_START + DP_STEPS)}, "max": {}, "moved": {}}
    for s in range(DP_START + 1, DP_START + DP_STEPS + 1):
        a, b = (read_checkpoint(os.path.join(log_root, k, "checkpoints", f"step_{s:09d}.pt"))
                ["params"] for k in (key, "dp_one"))
        d = torch.cat([(a[n] - b[n]).abs().reshape(-1) for n in b])
        out["max"][s] = float(d.max())
        out["moved"][s] = float((d > DP_MOVED_AT * lr).double().mean())
    vref = [r["val/psnr"] for r in ref.values() if "val/psnr" in r]
    vgot = [r["val/psnr"] for r in got.values() if "val/psnr" in r]
    out["val"] = (max(abs(x - y) / abs(y) for x, y in zip(vgot, vref)) if vref and vgot
                  else None)
    return out


def data_parallel(torch, data_root: str, args, cfg, dev) -> dict:
    """Phase 10: the default slice (1280 rays, one hand and the object, full
    width) for DP_STEPS steps from a seed checkpoint at step DP_START (the
    fused run's step-8 parameters, the hand's surface set to cut the rays),
    validating after each step: once in this process, then in DP_WORLD ranks
    sharing the card through gloo (``parallel.sharding.launch``), then the
    two controls in those ranks, which must fail the limits: ranks that
    average their own masked means, ranks that skip the gradient
    all-reduce.  Then one step in an NCCL group of one process.  Each rank's
    launches and every run's wall are printed; then phase 5's fused run's
    metrics read back from its ``jsonl:`` remote sink."""
    import torch.distributed as dist

    from hold_tpu_torch.data.dataset import SequenceData
    from hold_tpu_torch.parallel import sharding
    from hold_tpu_torch.train import run_training
    from hold_tpu_torch.utils.checkpoint import read_checkpoint, save_checkpoint

    t0 = time.perf_counter()
    # the seed is at step 9000, past the proposal's warmup: phase 10 keeps
    # the trunk's (fused) sampler, the proposal's warmup moved past its runs
    cfg = with_warmup(cfg, DP_START + DP_STEPS + 1)
    log_root = args["log_root"]
    seed = read_checkpoint(os.path.join(log_root, args["exp_key"], "checkpoints",
                                        f"step_{REFINE_STEP:09d}.pt"))
    seed["step"] = DP_START
    seed["params"][DP_SDF_BIAS][0] = -DP_HAND_RADIUS
    for key in ("one", "nccl") + DP_VARIANTS:
        shutil.rmtree(os.path.join(log_root, f"dp_{key}"), ignore_errors=True)
        save_checkpoint(os.path.join(log_root, f"dp_{key}"), DP_START, seed)
    seq = SequenceData.from_build_dir("synthetic", data_root, num_sample=RAYS_PER_FRAME)

    reset_kernel_launches()
    t1 = time.perf_counter()
    ph = run_training(dp_args(args, cfg, "dp_one", True), cfg, seq=seq, device=dev)[4].summary()
    torch.cuda.synchronize()
    one_s, one_launches = time.perf_counter() - t1, kernel_launches()
    print(f"  one process: {one_s * 1e3:.3f} ms (steps, checkpoints and validations); sampler_ms "
          f"{ph['sampler'] * 1e3:.3f}, grad_ms {ph['grad'] * 1e3:.3f} (the second step); "
          f"launches { {k: v for k, v in one_launches.items() if v} }", flush=True)

    t1 = time.perf_counter()
    ranks = sharding.launch(dp_worker, DP_WORLD, [str(dev)] * DP_WORLD,
                            (args, cfg, data_root), backend="gloo", timeout=600)
    print(f"  {DP_WORLD} ranks (gloo, one card), {len(DP_VARIANTS)} runs each: "
          f"{(time.perf_counter() - t1) * 1e3:.3f} ms with the processes' start", flush=True)
    for r, res in enumerate(ranks):
        for name in DP_VARIANTS:
            ph = res[name]["phases"]
            print(f"  rank {r} {name}: {res[name]['s'] * 1e3:.3f} ms; sampler_ms "
                  f"{ph['sampler'] * 1e3:.3f}, grad_ms {ph['grad'] * 1e3:.3f} (the second step); "
                  f"launches { {k: v for k, v in res[name]['launches'].items() if v} }",
                  flush=True)
    same = torch.equal(ranks[0]["split"]["digest"], ranks[1]["split"]["digest"])
    apart = not torch.equal(ranks[0]["no_allreduce"]["digest"], ranks[1]["no_allreduce"]["digest"])
    print(f"  ranks' parameters after the split run equal: {same}; after no_allreduce "
          f"apart: {apart}", flush=True)
    failed = []
    lr = float(args["lr"])
    for name in DP_VARIANTS:
        g = dp_gaps(torch, log_root, f"dp_{name}", lr)
        first = g["loss"][DP_START]
        within = (first <= DP_LOSS_RTOL and max(g["moved"].values()) <= DP_MOVED_SHARE
                  and (g["val"] is None or g["val"] <= DP_VAL_RTOL))
        print(f"  {name} vs one process: the first step's loss terms' worst relative gap "
              f"{first:.3e} (limit {DP_LOSS_RTOL:g}); parameters apart by more than "
              f"{DP_MOVED_AT:g} x lr after each step, share "
              f"{ {s: f'{v:.3e}' for s, v in g['moved'].items()} } (limit {DP_MOVED_SHARE:g}); "
              f"validation psnr gap {'-' if g['val'] is None else format(g['val'], '.3e')} "
              f"(limit {DP_VAL_RTOL:g}): {'within' if within else 'beyond'}; report only: the "
              f"later steps' loss gaps { {s: f'{v:.3e}' for s, v in g['loss'].items()} }, the "
              f"worst |d| { {s: f'{v:.3e}' for s, v in g['max'].items()} }", flush=True)
        if within != (name == "split"):
            failed.append(name)
    for name in DP_VARIANTS:
        if ranks[0][name]["launches"] != ranks[1][name]["launches"]:
            failed.append(f"{name} launches differ between the ranks")
    if not same or not apart:
        failed.append(f"ranks' parameters equal {same}, apart without the all-reduce {apart}")
    for path, got in (("dp_one", one_launches), ("dp_rank0", ranks[0]["split"]["launches"]),
                      ("dp_rank1", ranks[1]["split"]["launches"])):
        failed += path_check(path, got)

    # one step in an NCCL group of one process: the split path on NCCL
    port = sharding.free_port()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0)
    try:
        a = dp_args(args, cfg, "dp_nccl", False)
        a["total_step"] = DP_START + 1
        reset_kernel_launches()
        run_training(a, cfg, seq=seq, device=dev)
        nccl_launches = kernel_launches()
    finally:
        dist.destroy_process_group()
    ref, got = dp_records(log_root, "dp_one")[DP_START], dp_records(log_root, "dp_nccl")[DP_START]
    gap = max(abs(got[k] - v) / max(abs(v), 1e-12) for k, v in ref.items()
              if k.startswith("loss") or k == "psnr")
    print(f"  NCCL, world 1, one step: loss terms' worst relative gap to one process {gap:.3e} "
          f"(limit {DP_LOSS_RTOL:g}); launches { {k: v for k, v in nccl_launches.items() if v} }",
          flush=True)
    if gap > DP_LOSS_RTOL:
        failed.append("nccl")
    failed += path_check("dp_nccl", nccl_launches)

    # phase 5's fused run, its metrics through the jsonl: sink
    with open(REMOTE_SPOOL) as f:
        streamed = [r["data"] for r in map(json.loads, f) if r["kind"] == "metrics"]
    with open(os.path.join(log_root, args["exp_key"], "metrics.jsonl")) as f:
        local = [json.loads(line) for line in f]
    equal = local[:len(streamed)] == streamed
    print(f"  remote sink: {len(streamed)} metric records streamed (phase 5's fused run and its "
          f"resumption), {len(local)} in its metrics.jsonl; the streamed ones are its first: "
          f"{equal}", flush=True)
    if len(streamed) < STEPS + 2 or not equal:
        failed.append("remote sink")
    print(f"  phase 10 {time.perf_counter() - t0:.1f} s", flush=True)
    if failed:
        raise AssertionError(f"data parallel: {failed}")
    return {"dp_one": one_launches, "dp_rank0": ranks[0]["split"]["launches"],
            "dp_rank1": ranks[1]["split"]["launches"], "dp_nccl": nccl_launches}

# phase 11: (path, rays a frame, steps, model.proposal.warmup, training CLI
# flags).  The proposal's warmup is cut from 1000 so that proposal mode
# starts within a few steps; "prop_5120_step0" samples through the
# undistilled proposal from step 0, as the JAX benchmark did where the JAX
# package read NaN at 5,120 rays.
PROPOSAL_RUNS = (
    ("prop_1280", 128, 4, 2, ()),
    ("prop_5120", 512, 3, 2, ()),
    ("prop_5120_step0", 512, 1, 0, ()),
    ("knobs", 128, 3, 2, ("--node_bounds", "--sampler_relu", "--sampler_knn_stride",
                          str(STRIDE))),
    ("prop_10240", 1024, 2, 1, ()),
    ("prop_20480", 2048, 2, 1, ()),
)
# the fused query's counters of each sampler: the relu trunk's with
# --sampler_relu
TRUNK_QUERIES = ("fused_hand_sampler_sdf_z", "fused_object_sampler_sdf_z")


def with_warmup(cfg, warmup: int):
    """``cfg`` with ``model.proposal.warmup`` set."""
    import copy

    out = copy.deepcopy(dict(cfg))
    out["model"]["proposal"] = dict(out["model"]["proposal"], warmup=warmup)
    return out


def tensors_finite(torch, tree) -> list:
    """The paths of the non-finite tensors of a flat dict."""
    return [k for k, t in tree.items() if not bool(torch.isfinite(t.detach()).all())]


def stage_profile(torch, fn) -> tuple:
    """(device ms, launches) of one call of ``fn`` under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total, n, _ = device_split(torch, prof)
    return total, n


def proposal_run(torch, seq, args, cfg, dev, path: str, rays: int, steps: int, warmup: int,
                 flags: tuple) -> dict:
    """Phase 11, one run: ``make_train_step`` (what ``run_training`` calls a
    step) on the scene ``run_training`` builds from the training CLI's
    ``flags``, ``steps`` steps of 10 frames x ``rays`` rays from step 0,
    proposal mode from ``warmup``.  Each step, from counters at 0: every loss
    term, every parameter and every z table finite, z non-decreasing along
    each ray, ``loss/proposal`` > 0; in proposal mode row 1 launched for
    each hand and none of rows 5-6, otherwise rows 5-6 (their relu form
    with --sampler_relu) and no row 1.  Nothing is caught: a non-finite
    value ends the run.  Returns the run's launches, and per mode the
    stages' mean walls, one profiled step's device time and launches, and
    the peak memory."""
    import numpy as np
    from unittest import mock

    from hold_tpu_torch import train
    from hold_tpu_torch.models.holdnet import (
        build_scene, empty_object_mesh_state, init_scene_params, sample_all_z,
    )
    from hold_tpu_torch.utils.config import build_argparser, sampler_flags
    from hold_tpu_torch.utils.convert import flatten_params
    from hold_tpu_torch.utils.tracing import StepTimer

    knobs = sampler_flags(vars(build_argparser().parse_args(["--case", "synthetic", *flags])))
    opt_model = dict(with_warmup(cfg, warmup)["model"])
    opt_model["scene_bounding_sphere"] = seq.scene_bounding_sphere
    scene = build_scene(opt_model, dict(args), seq.scene_data(), dev, **knobs)
    if train.proposal_schedule(scene) != warmup:
        raise AssertionError(f"{path}: the scene's proposal starts at "
                             f"{train.proposal_schedule(scene)}, not {warmup}")
    params = init_scene_params(torch.Generator().manual_seed(0), scene, seq.scene_data())
    opt = train.optimizer_for(args, params, float(opt_model["proposal"]["lr"]))
    timer = StepTimer()
    step_fn = train.make_train_step(scene, opt, timer)
    mesh_state = empty_object_mesh_state(dev)
    rng = np.random.RandomState(11)
    gen = torch.Generator(dev).manual_seed(11)
    seen = []

    def recording(*a, **k):
        z = sample_all_z(*a, **k)
        seen.append((k.get("proposal_mode", False), z))
        return z

    relu = knobs["sampler_relu"]
    rows56 = tuple(n + (".relu" if relu else "") for n in TRUNK_QUERIES)
    hands = sum(nid != "object" for nid in scene.node_ids)
    total = {}
    modes = {False: {"sampler": [], "grad": [], "peak": 0}, True: {"sampler": [], "grad": [],
                                                                    "peak": 0}}
    print(f"  -- {path}: {steps} steps of {BATCH_SIZE * 2} frames x {rays} rays, proposal "
          f"mode from step {warmup}, flags {' '.join(flags) or '(none)'}", flush=True)
    last_batch = None
    for step in range(steps):
        batch = train.batch_to_device(seq.sample_tempo_batch(rng, BATCH_SIZE, 1, rays), dev)
        last_batch = batch
        reset_kernel_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        seen.clear()
        before = dict(timer.totals)
        with mock.patch.object(train, "sample_all_z", recording):
            aux = step_fn(params, batch, mesh_state, gen, step, 0)
        torch.cuda.synchronize()
        launches = kernel_launches()
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        mode, z = seen[0]
        rec = modes[mode]
        for ph in ("sampler", "grad"):
            rec[ph].append(timer.totals[ph] - before.get(ph, 0.0))
        rec["peak"] = max(rec["peak"], torch.cuda.max_memory_allocated())
        bad = [k for k, v in aux.items() if not bool(torch.isfinite(v))]
        bad += tensors_finite(torch, flatten_params(params))
        bad += [f"z {nid}" for nid in tensors_finite(torch, z)]
        unsorted = [nid for nid, t in z.items() if bool((torch.diff(t, dim=1) < 0).any())]
        want_warp = hands if mode else 0
        wrong = []
        if launches["knn_inverse_warp"] != want_warp * scene.sampler_cfg.max_total_iters:
            wrong.append(f"knn_inverse_warp {launches['knn_inverse_warp']}")
        for k in rows56:
            if (launches[k] > 0) == mode:
                wrong.append(f"{k} {launches[k]}")
        off = [k for k in TRUNK_QUERIES + tuple(n + ".relu" for n in TRUNK_QUERIES)
               if k not in rows56 and launches[k]]
        print(f"  step {step} ({'proposal' if mode else 'trunk'} sampler): loss "
              f"{float(aux['loss']):.5f} proposal {float(aux['loss/proposal']):.5f} rgb "
              f"{float(aux['loss/rgb']):.5f}; sampler {rec['sampler'][-1] * 1e3:.3f} ms, grad "
              f"{rec['grad'][-1] * 1e3:.3f} ms; z in [{min(float(t.min()) for t in z.values()):.4f}"
              f", {max(float(t.max()) for t in z.values()):.4f}]; row 1 "
              f"{launches['knn_inverse_warp']}, rows 5-6 {[launches[k] for k in rows56]}",
              flush=True)
        if bad or unsorted or wrong or off or not float(aux["loss/proposal"]) > 0:
            raise AssertionError(f"{path} step {step}: non-finite {bad[:8]}, unsorted z "
                                 f"{unsorted}, launches {wrong + off}, loss/proposal "
                                 f"{float(aux['loss/proposal'])}")
    out = {"launches": total, "modes": {}}
    for mode, rec in modes.items():
        if not rec["sampler"]:
            continue
        # one more sampler stage and grad stage of this mode, profiled
        z = sample_all_z(params, scene, last_batch, gen, steps, 0, proposal_mode=mode)
        s_dev = stage_profile(torch, lambda: sample_all_z(params, scene, last_batch, gen, steps,
                                                          0, proposal_mode=mode))
        B, P = last_batch["uv"].shape[:2]

        def grad():
            from hold_tpu_torch.models.holdnet import holdnet_forward, sample_step_draws
            from hold_tpu_torch.models.losses import compute_losses

            draws = sample_step_draws(scene, B, P, gen)
            opt.zero_grad(set_to_none=True)
            o = holdnet_forward(params, scene, last_batch, mesh_state, draws, steps, 0,
                                z_vals_dict=z)
            compute_losses(last_batch, o, scene.node_ids, steps)["loss"].backward()
            opt.step()

        g_dev = stage_profile(torch, grad)
        r = {"sampler_ms": 1e3 * float(np.mean(rec["sampler"])),
             "grad_ms": 1e3 * float(np.mean(rec["grad"])),
             "sampler_device_ms": s_dev[0], "sampler_launches": s_dev[1],
             "grad_device_ms": g_dev[0], "grad_launches": g_dev[1],
             "peak_gib": rec["peak"] / 2**30, "steps": len(rec["sampler"])}
        out["modes"]["proposal" if mode else "trunk"] = r
        print(f"  {path}, {'proposal' if mode else 'trunk'} sampler ({r['steps']} steps): "
              f"sampler_ms {r['sampler_ms']:.3f} (device {r['sampler_device_ms']:.3f} ms in "
              f"{r['sampler_launches']} launches), grad_ms {r['grad_ms']:.3f} (device "
              f"{r['grad_device_ms']:.3f} ms in {r['grad_launches']} launches), peak "
              f"{r['peak_gib']:.3f} GiB", flush=True)
    bad = path_check(path, total)
    if bad:
        raise AssertionError(bad[0])
    return out


def proposal_and_knobs(torch, seq, args, cfg, dev) -> dict:
    """Phase 11: PROPOSAL_RUNS at full width (the JAX DEFAULT_CONFIG); the
    launches of each, by path."""
    t0 = time.perf_counter()
    launches, summary = {}, {}
    for path, rays, steps, warmup, flags in PROPOSAL_RUNS:
        res = proposal_run(torch, seq, args, cfg, dev, path, rays, steps, warmup, flags)
        launches[path], summary[path] = res["launches"], res["modes"]
    print(f"  phase 11 {time.perf_counter() - t0:.1f} s: {json.dumps(summary)}", flush=True)
    return launches


@contextlib.contextmanager
def recorded_proposal(calls: list):
    """While open, every call of the proposal net from the nodes' samplers
    is appended to ``calls`` as (args, kwargs, output)."""
    from hold_tpu_torch.models import nodes

    real = nodes.apply_proposal_net

    def call(*a, **k):
        out = real(*a, **k)
        calls.append((a, k, out))
        return out

    nodes.apply_proposal_net = call
    try:
        yield
    finally:
        nodes.apply_proposal_net = real


@contextlib.contextmanager
def unrounded_proposal():
    """The samplers' proposal net on its float32 tree, not the bf16 one
    (phase 4's control)."""
    from hold_tpu_torch.models import nodes

    real = nodes.cast_tree
    nodes.cast_tree = lambda tree, dtype: tree
    try:
        yield
    finally:
        nodes.cast_tree = real


def proposal_agreement(torch, seq, args, cfg, dev) -> None:
    """Phase 4, proposal mode: the sampler stage on 1 pair of frames x 16
    rays with the proposal nets in place of the trunk, card against CPU at
    the same parameters: every z table finite and sorted; row 1 launched
    for the hand on the card, none of rows 5-6; the sdf that the card's
    proposal read, every call at its own inputs, against the CPU's at the
    same inputs under the fused query's bounds; the z samples moved beyond
    0.1 x the median spacing held under the limit of ``Z_MOVED_F64``'s rule
    ("proposal"), and the card's proposal on its float32 tree (its bf16
    roundings left out: the control) beyond it."""
    import numpy as np

    from hold_tpu_torch.models.holdnet import build_scene, init_scene_params, sample_all_z
    from hold_tpu_torch.models.mlp import apply_proposal_net
    from hold_tpu_torch.train import batch_to_device
    from hold_tpu_torch.utils.convert import leaf_params

    step, epoch = 300, 25
    opt_model = dict(cfg["model"])
    batch_np = seq.sample_tempo_batch(np.random.RandomState(1), 1, 1, 16)
    cpu = torch.device("cpu")
    scenes = {d.type: build_scene(opt_model, dict(args), seq.scene_data(), d) for d in (dev, cpu)}
    if any(p.proposal is None for p in scenes["cpu"].plans.values()):
        raise AssertionError("the slice's scene has no proposal net")
    params0 = init_scene_params(torch.Generator().manual_seed(3), scenes["cpu"], seq.scene_data())

    def run(device):
        return sample_all_z(leaf_params(params0, device), scenes[device.type],
                            batch_to_device(batch_np, device), None, step, epoch,
                            proposal_mode=True)

    calls = []
    reset_kernel_launches()
    with recorded_proposal(calls):
        z_card = run(dev)
    torch.cuda.synchronize()
    got = kernel_launches()
    z_cpu = run(cpu)
    with unrounded_proposal():
        z_f32 = run(dev)
    rounds = scenes["cpu"].sampler_cfg.max_total_iters
    rows56 = {k: got[k] for k in TRUNK_QUERIES + tuple(n + ".relu" for n in TRUNK_QUERIES)}
    print(f"  proposal mode on the card: row 1 {got['knn_inverse_warp']} launches (the hand, "
          f"{rounds} rounds), rows 5-6 {rows56}", flush=True)
    if got["knn_inverse_warp"] != rounds or any(rows56.values()):
        raise AssertionError("proposal mode: row 1 not launched once a round, or rows 5-6 were")
    bad = [nid for nid, t in z_card.items()
           if not bool(torch.isfinite(t).all()) or bool((torch.diff(t, dim=1) < 0).any())]
    if bad:
        raise AssertionError(f"proposal mode: z tables non-finite or unsorted: {bad}")

    def to_cpu(x):
        if isinstance(x, dict):
            return {k: to_cpu(v) for k, v in x.items()}
        if isinstance(x, list):
            return [to_cpu(v) for v in x]
        return x.cpu() if torch.is_tensor(x) else x

    read = torch.cat([out.reshape(-1).cpu() for _, _, out in calls])
    ref = torch.cat([apply_proposal_net(*to_cpu(list(a)), **to_cpu(k)).reshape(-1)
                     for a, k, _ in calls])
    check_bf16_query(f"the sdf the card's proposal read ({len(calls)} calls, {read.numel()} "
                     f"points), card vs CPU at the same inputs", read, ref)
    worst = max(z_moved_share(torch, z_card[n], z_cpu[n])[0] for n in z_cpu)
    worst32 = max(z_moved_share(torch, z_f32[n], z_cpu[n])[0] for n in z_cpu)
    for nid in z_cpu:
        print(f"  proposal z table {nid}, samples moved beyond 0.1 x the median spacing: card "
              f"vs CPU {z_moved(torch, z_card[nid], z_cpu[nid])}, the card's proposal "
              f"unrounded {z_moved(torch, z_f32[nid], z_cpu[nid])}; {z_card[nid].numel()} "
              f"samples", flush=True)
    limit = z_moved_limit("proposal", z_cpu["object"].numel())
    print(f"  proposal z tables: worst share card vs CPU {worst:.5f} (limit {limit:.5f}) "
          f"{'ok' if worst <= limit else 'FAIL'}; the unrounded control's {worst32:.5f} "
          f"{'fails it: ok' if worst32 > limit else 'passes: FAIL'}", flush=True)
    if worst > limit or worst32 <= limit:
        raise AssertionError("proposal z tables: card and CPU apart, or the unrounded control "
                             "within")


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", type=str, default="",
                    help="run only these phases after 1-2 (comma-separated, e.g. 3,4,11): a "
                         "partial run prints no result and checks no path it skipped")
    only = {int(x) for x in ap.parse_args(argv).phases.split(",") if x}

    def want(n: int) -> bool:
        return not only or n in only

    if not os.path.isdir(os.path.join(ROOT, "hold_tpu_torch")):
        print("chip_smoke.py must run from a checkout holding hold_tpu_torch/", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the port's kernels run only on the card", file=sys.stderr)
        return 3
    sys.path.insert(0, ROOT)
    t_all = time.perf_counter()
    # a run that finds its experiment's checkpoint resumes from it: start clean
    shutil.rmtree(os.path.join(ROOT, "logs", "chip_smoke"), ignore_errors=True)

    phase("1 environment")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"  python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}")
    print(f"  card: {smi}")
    import importlib.util

    for mod in ("cv2", "PIL", "yaml"):
        print(f"  {mod}: {'present' if importlib.util.find_spec(mod) else 'absent'}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    phase("2 build")
    from hold_tpu_torch.ops import _cuda

    _cuda.lib()
    info = _cuda.build_info
    print(f"  {info['path']}: {info['seconds']:.1f} s ({'cached' if info['cached'] else 'built'})")
    kernel = "?"
    for line in info["ptxas"].splitlines():
        if "Compiling entry function" in line:
            kernel = kernel_label(line)
        elif "registers" in line or "spill" in line:
            print(f"  {kernel}: {line.split('info    :')[-1].strip()}")

    from hold_tpu_torch.meshing import mise

    t0 = time.perf_counter()
    print(f"  {mise._build_lib()}: {time.perf_counter() - t0:.1f} s (g++, or found built)",
          flush=True)

    from hold_tpu_torch.data.dataset import SequenceData
    from hold_tpu_torch.data.synthetic import generate_sequence

    data_root = os.path.join(ROOT, "logs", "chip_smoke", "data")
    built = generate_sequence(os.path.join(data_root, "synthetic"), FRAMES, IMG_HW)
    seq = SequenceData(built["images"], built["masks"], built["data"], num_sample=RAYS_PER_FRAME)
    args, cfg = slice_config()

    if want(3):
        phase("3 kernel checks")
        results = kernel_checks(torch, seq, args, cfg, dev)
        fast_shape_checks(torch, seq, data_root, dev, results)
        fast_shade_checks(torch, seq, data_root, dev, results)
        bench_shape_checks(torch, seq, args, cfg, dev, results)
        error_bound_checks(torch, seq, args, cfg, dev, results)
    if want(4):
        card_vs_cpu(torch, seq, data_root, args, cfg, dev)
    if only and only <= {3, 4, 11}:
        if 11 in only:
            phase("11 proposal and sampler knobs")
            proposal_and_knobs(torch, seq, args, cfg, dev)
        print(f"  total {time.perf_counter() - t_all:.1f} s; a partial run (--phases): no result")
        return 0
    if only:
        raise SystemExit("--phases: phases 5-10 depend on each other; run them all")
    launches = train_and_serve(torch, seq, data_root, args, cfg, dev, t_all)

    phase("11 proposal and sampler knobs: the trunk sampler then proposal mode at 1280, "
          "5120, 10240 and 20480 rays, proposal mode from step 0, the relu trunk and the "
          "strided search")
    launches.update(proposal_and_knobs(torch, seq, args, cfg, dev))
    print(f"  total {time.perf_counter() - t_all:.1f} s", flush=True)

    kernels = []
    for name, (src, replaces, paths) in KERNELS.items():
        r = results[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[src], "replaces": replaces,
            "launches": launches[paths[0]][name] if paths else 0,
            "path": paths[0] if paths else None,
            "launches_by_path": {k: v[name] for k, v in launches.items()},
            **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms", "shape")},
            **{k: r[k] for k in ("mean_abs_err", "trunk_tflop_s", "tflop_s", "errors",
                                 "normal_p99", "split_ms", "wrapper_ms", "search", "support",
                                 "buffers", "brute_force_bound_ms", "library_call",
                                 "library_note", "fast", "bench", "softplus_ms") if k in r},
        })
    for name, (counter, path) in FORMS.items():
        base, r = KERNELS[counter], results[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[base[0]], "replaces": base[1],
            "launches": launches[path][counter], "path": path, "counted_as": counter,
            **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms", "shape")},
            **{k: r[k] for k in ("mean_abs_err", "trunk_tflop_s", "search",
                                 "brute_force_bound_ms", "library_note") if k in r},
        })
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def card_vs_cpu(torch, seq, data_root, args, cfg, dev) -> None:
    """Phase 4."""
    phase("4 card vs CPU agreement on a small batch")
    print("  -- chunked shade (--no_fused_train), float32 (--shade_f32)", flush=True)
    agreement_check(torch, seq, args, cfg, dev, fused_train=False)
    print("  -- chunked shade (--no_fused_train), its bf16 products (the card's default)",
          flush=True)
    agreement_check(torch, seq, args, cfg, dev, fused_train=False, shade_f32=False)
    print("  -- fused training shade", flush=True)
    agreement_check(torch, seq, args, cfg, dev, fused_train=True)
    print("  -- fused training shade, the -f scene at its shapes (10 frames x 8 rays)",
          flush=True)
    fast_args, fast_cfg = fast_config(data_root)
    agreement_check(torch, seq, fast_args, fast_cfg, dev, fused_train=True, pairs=BATCH_SIZE,
                    rays=int(fast_args["num_sample"]), z_case="fast")
    print("  -- render", flush=True)
    render_agreement(torch, seq, args, cfg, dev)
    print("  -- the sampler in proposal mode", flush=True)
    proposal_agreement(torch, seq, args, cfg, dev)


def train_and_serve(torch, seq, data_root, args, cfg, dev, t_all) -> dict:
    """Phases 5-10; the launches of each run by path."""
    phase(f"5 the slice: run_training, {STEPS} steps fused and validated, resumed for 2, "
          f"{LAYER_STEPS} layer by layer, {LAYER_STEPS} with the chunked shade, 2 at -f, "
          f"{LAYER_STEPS} with two hands")
    from hold_tpu_torch.utils.config import Cfg

    # the defaults, with meshing and validation: two steps an epoch, so that
    # the cadence meshes at epoch 3 after the last step, on its worker
    # thread, and checkpoints and validates there
    fused_args = Cfg({**args, "no_meshing": False, "tempo_len": 2 * BATCH_SIZE, "no_vis": False,
                      "eval_every_epoch": 3, "mute": False,
                      "remote_track": f"jsonl:{REMOTE_SPOOL}"})
    fused_launches, fused = slice_run(torch, seq, fused_args, cfg, dev, STEPS)
    loop_outputs(fused[3].log_dir, STEPS, val=True)
    sampler_exponentials_cost(torch, seq, args, fused[1], fused[0], dev)
    print("  -- canonical meshing and the object's mesh state", flush=True)
    meshing_checks(torch, seq, args, dev, fused)
    del fused
    print("  -- resume", flush=True)
    launches = {"fused": fused_launches, "resume": resume_checks(torch, seq, fused_args, cfg, dev)}
    launches["layer"] = slice_run(torch, seq, Cfg({**args, "no_fused_sampler": True,
                                                   "exp_key": "chip_smoke_layer"}),
                                  cfg, dev, LAYER_STEPS)[0]
    launches["chunked"] = slice_run(torch, seq, Cfg({**args, "no_fused_train": True,
                                                     "exp_key": "chip_smoke_chunked"}),
                                    cfg, dev, LAYER_STEPS)[0]
    # the chunked shade in float32 (--shade_f32) beside its bf16 default on
    # the card, for its device time and peak memory
    slice_run(torch, seq, Cfg({**args, "no_fused_train": True, "shade_f32": True,
                               "exp_key": "chip_smoke_chunked_f32"}), cfg, dev, 2)
    # the chunked shade once more with every chunk's graph kept, for its peak
    # memory beside the recomputing default's
    slice_run(torch, seq, Cfg({**args, "no_fused_train": True, "no_remat": True,
                               "exp_key": "chip_smoke_no_remat"}), cfg, dev, 2)
    launches["fast"] = fast_run(torch, seq, data_root, dev)
    launches["two_hands"] = two_hand_run(torch, args, cfg, dev, launches)

    phase(f"6 the render slice: render_cli, {RENDER_FRAMES} frames at render_downsample "
          f"{RENDER_DOWNSAMPLE}")
    launches.update(render_slice(torch, seq, data_root, args, dev))

    phase("7 evaluation against the synthetic ground truth")
    evaluation(torch, data_root, args, cfg, dev)

    phase(f"8 refinement and viewing: optimize_ckpt --iters {REFINE_ITERS} on step "
          f"{REFINE_STEP}, evaluate and visualize_ckpt on the refined checkpoint")
    t8 = time.perf_counter()
    refinement(torch, data_root, args, dev, launches)
    print(f"  phase 8 {time.perf_counter() - t8:.1f} s; total {time.perf_counter() - t_all:.1f} s")

    phase(f"9 real-format data: an HO3D v3 sequence through process_ho3d, evaluate --gt ho3d, "
          f"a build_dataset sequence trained for 2 steps")
    launches["built"] = real_format_data(torch, data_root, args, cfg, dev)

    phase(f"10 data parallel: {DP_STEPS} steps in one process and in {DP_WORLD} ranks (gloo, "
          f"one card), two controls, one NCCL step, the remote sink")
    launches.update(data_parallel(torch, data_root, args, cfg, dev))
    print(f"  phases 5-10 end at {time.perf_counter() - t_all:.1f} s", flush=True)
    return launches


if __name__ == "__main__":
    sys.exit(main())
